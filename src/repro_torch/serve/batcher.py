"""Shape-bucketed micro-batching for GCN queries, replayed as CUDA graphs.

The port of ``repro.serve.batcher``.  Sampled subgraphs have a different
shape per request; the batcher keeps the set of shapes finite with a small
geometric ladder of ``(nodes, ell_rows)`` buckets:

* every extracted subgraph is padded up to the smallest bucket that fits
  (PAD_COL ELL slots, zero feature rows), so the operand shapes are the
  ladder x a power-of-two batch ladder — enumerable, and therefore all
  built at warmup;
* concurrent requests in the same bucket are coalesced into one
  block-diagonal operand (each request's columns and output rows offset by
  its slot x bucket nodes), so a batch of B subgraphs runs as **one**
  aggregation (or fused) launch per layer, through
  ``exec.dispatch.execute_layer`` and the port's own kernels;
* one executable is built per ``(bucket, batch, feature_dim, precision,
  param signature)`` and counted in ``compiles`` (the reference's name,
  so the zero-builds-after-warmup guarantee is tested the same way).  On
  the card an executable is a ``torch.cuda.CUDAGraph`` captured over the
  coalesced forward, reading static input and parameter buffers: a run
  copies the stacked requests and the caller's parameters into them,
  replays the graph and reads back the seed rows.  On the CPU it is the
  same forward as a closure.  A capture that fails raises.

Replays do not pass through the kernel wrappers, so ``LAUNCHES`` and the
``LEDGER`` records see a rung's kernels once, at its capture (as the
reference's AOT executables are traced once); a CPU closure runs with the
ledger muted, so it records nothing either.  :meth:`record_batch_dram`
ledgers a coalesced forward host-side, and each captured graph keeps the
launches of one forward and its replay count.

:meth:`MicroBatcher.run` may be called from several threads (the async
runtime's worker, a caller draining it): a lock serializes the lookup or
build of an executable and its run, whose static buffers are shared.

The fused kernels take slot lists (``kernels.flexvector_spmm.column_slots``)
that the dispatcher builds from the ELL table on the host, which a capture
cannot read back.  So :meth:`MicroBatcher.prepare` builds each request's
slot lists from its numpy columns, and a run offsets and concatenates
them per slot into buffers padded, with empty chunks, to the rung's chunk
bound (the chunk count is the kernel's grid, fixed in the graph).

With ``autoplan`` each rung gets its own plans from the cost model
(``plan.autoplan`` / ``exec.pipeline`` over the rung's padded shape), and
each rung may store its own precision (``set_bucket_precision``, the
engine's ``precision="auto"``); both are fixed before the rung's graph is
captured, and a rung builds slot lists only when one of its layers runs a
fused kernel.

The top ladder entry is sized from the full graph's preprocessed operand,
so any subgraph fits some bucket.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse_formats import PAD_COL
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import LEDGER
from repro_torch.exec import SpmmOperands, SpmmPlan, plan_for_config, quant
from repro_torch.exec.dispatch import execute_layer, record_spmm_dram
from repro_torch.exec.fused import provide_column_slots, record_combination_dram
from repro_torch.kernels import flexvector_spmm as fv
from repro_torch.models.gcn import GCNConfig, GCNGraph
from repro_torch.serve.sampler import SampledSubgraph

_SLOT_INPUTS = ("slot_group", "slot_start", "slot_ids")


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One ladder rung: per-request padded (dense nodes, ELL rows)."""

    nodes: int
    rows: int


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def ladder_rungs(base: int, top: int, growth: float, quantum: int) -> List[int]:
    """Node counts of a geometric ladder: ``base`` up to ``top`` by factor
    ``growth``, every rung rounded up to ``quantum`` and strictly
    increasing (a fractional factor whose step rounds away still advances
    by one quantum, so the ladder always terminates at ``top``)."""
    if growth <= 1:
        raise ValueError(f"ladder growth must be > 1, got {growth}")
    rungs = [min(base, top)]
    while rungs[-1] < top:
        nxt = max(_round_up(int(rungs[-1] * growth), quantum),
                  rungs[-1] + quantum)
        rungs.append(min(nxt, top))
    return rungs


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    entries: Tuple[Bucket, ...]   # ascending
    mean_row_nnz: float = 0.0     # graph's mean nnz per sub-row (cost stats)

    @staticmethod
    def for_graph(
        full_graph: GCNGraph,
        cfg: GCNConfig,
        base_nodes: int = 256,
        growth=4,
        device_model=None,
    ) -> "BucketLadder":
        """Geometric ladder capped by the full graph's operand.

        The per-rung ELL-row budget comes from the graph statistics:
        ``rows = nodes * stats.rows_per_node`` ties it to the graph's own
        vertex-cut expansion factor, and ``mean_row_nnz`` is carried on
        the ladder.  The top entry covers the whole graph, so escalation
        always terminates.  ``growth`` is any factor > 1, or ``"auto"`` to
        let the cost model pick one
        (:func:`repro_torch.plan.autoplan.choose_ladder_growth`: padded
        work against rung builds, scored on this graph's statistics with
        ``device_model``, the H100 kernel model when None).
        """
        from repro_torch.plan import cost

        stats = cost.graph_stats_from_ell(full_graph.pre.ell)
        top_nodes = _round_up(full_graph.n_nodes, cfg.block_k)
        base = min(_round_up(base_nodes, cfg.block_k), top_nodes)
        if growth == "auto":
            from repro_torch.plan.autoplan import choose_ladder_growth

            growth = choose_ladder_growth(
                stats, cfg, base_nodes=base, top_nodes=top_nodes,
                device=device_model)
        entries = tuple(
            Bucket(nodes=n, rows=_round_up(n * stats.rows_per_node,
                                           cfg.block_rows))
            for n in ladder_rungs(base, top_nodes, growth, cfg.block_k)
        )
        return BucketLadder(entries=entries, mean_row_nnz=stats.mean_row_nnz)

    def bucket_for(self, n_sub_nodes: int, n_ell_rows: int) -> Bucket:
        for b in self.entries:
            if b.nodes >= n_sub_nodes and b.rows >= n_ell_rows:
                return b
        raise ValueError(
            f"no bucket fits (nodes={n_sub_nodes}, rows={n_ell_rows}); "
            f"ladder top is {self.entries[-1]}"
        )


@dataclasses.dataclass
class PaddedRequest:
    """A subgraph padded to its bucket, ready to coalesce (host arrays)."""

    bucket: Bucket
    cols: np.ndarray      # (rows, tau) int32, PAD_COL padding
    # (rows, tau): f32 or int8 numpy, or a CPU torch.bfloat16 tensor (numpy
    # has no bfloat16), per the rung's precision
    vals: object
    row_map: np.ndarray   # (rows,) int32, -1 padding
    feats: np.ndarray     # (nodes, F) float32, permuted node order
    seed_pos: np.ndarray  # (max_seeds,) int32 output rows to read, -1 padding
    n_seeds: int
    # (rows / block_rows,) f32 per-row-block scales when vals are int8
    scales: Optional[np.ndarray] = None
    # the fused kernels' (group, start, ids) slot lists of ``cols``, on a
    # rung that runs them
    slots: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


class _CapturedForward:
    """One rung's coalesced forward as a CUDA graph over static buffers.

    The buffers are filled with padding (PAD_COL columns, empty slot
    chunks) and the caller's parameters, the forward runs once on a side
    stream (the kernel library loads and the kernels' attributes are set
    outside the capture), and is then captured into ``pool``.

    The kernel wrappers count their launches once, at the capture; a
    replay runs the same launches again without them.  ``launches`` keeps
    what one forward launches (``fv.PRECISION_LAUNCHES`` keys) and
    ``replays`` how often it ran since, so replays x ``launches`` is what
    the replays launched.
    """

    def __init__(self, fwd: Callable, params, specs: dict,
                 device: torch.device, pool):
        self.params = {name: {k: torch.as_tensor(v, device=device).clone()
                              for k, v in layer.items()}
                       for name, layer in params.items()}
        self.inputs = {name: torch.full(shape, fill, dtype=dtype, device=device)
                       for name, (shape, dtype, fill) in specs.items()}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fwd(self.params, self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = dict(fv.PRECISION_LAUNCHES)
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fwd(self.params, self.inputs)
        self.launches = {k: n - before[k]
                         for k, n in fv.PRECISION_LAUNCHES.items()
                         if n != before[k]}
        self.replays = 0

    def __call__(self, params, inputs: Dict[str, torch.Tensor]) -> np.ndarray:
        for name, layer in params.items():
            for k, v in layer.items():
                self.params[name][k].copy_(v)
        for name, t in inputs.items():
            self.inputs[name].copy_(t)
        self.graph.replay()
        self.replays += 1
        return self.out.cpu().numpy()


class _EagerForward:
    """One rung's coalesced forward as a closure (CPU tensors)."""

    def __init__(self, fwd: Callable):
        self.fwd = fwd

    def __call__(self, params, inputs: Dict[str, torch.Tensor]) -> np.ndarray:
        with LEDGER.muted():
            return self.fwd(params, inputs).numpy()


class MicroBatcher:
    """Pads requests into buckets and runs coalesced forwards."""

    def __init__(
        self,
        cfg: GCNConfig,
        ladder: BucketLadder,
        *,
        max_batch: int = 8,
        max_seeds: int = 16,
        mesh=None,
        autoplan: bool = False,
        precision: str = "f32",
        fused: Optional[bool] = None,
        feedback=None,
        device=None,
        device_model=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: sharding bucket chunks over ranks is ROADMAP item A9b "
                "(the serving mesh), not ported yet")
        self.cfg = cfg
        self.ladder = ladder
        self.max_batch = max_batch
        self.max_seeds = max_seeds
        self.device = resolve_device(device)
        # Optional repro_torch.obs.feedback.PlanFeedback store: with
        # ``autoplan`` on, per-rung planning prices a candidate by its
        # measured execute latency before the modeled cost.  Plans stay
        # pinned by the per-rung caches below, so feedback arriving after
        # a rung was built never rebuilds it: it informs the next engine.
        self.feedback = feedback
        # Kernel fusion per layer: ``None`` leaves it to the planner
        # (``autoplan`` may fuse layers it prices cheaper; otherwise two
        # launches), ``True``/``False`` force it on every kernel layer.
        self.fused = fused
        # Default storage precision of every rung; per-rung overrides land
        # in _bucket_precisions through set_bucket_precision before the
        # rung is built.
        self.precision = quant.validate_precision(precision)
        self._bucket_precisions: Dict[Bucket, str] = {}
        # The coalesced operand carries no host TiledELL, so the plan
        # resolves here, once: a cuda_sparse config records (and warns)
        # its degradation to the dense grid (``plan.degraded_reason``).
        self.plan = plan_for_config(cfg).resolve(schedulable=False)
        self.autoplan = autoplan
        # the cost model rung plans are chosen on (None: the H100 model)
        self.device_model = device_model
        self.compiles = 0          # executables built (warmup or on-demand)
        self.calls = 0             # coalesced forward invocations
        self._executables: Dict[tuple, object] = {}
        self._bucket_plans: Dict[Tuple[Bucket, int], SpmmPlan] = {}
        self._layer_plans: Dict[Tuple[Bucket, int], List[SpmmPlan]] = {}
        self._pool = None          # the captures' CUDA graph memory pool
        self._run_lock = threading.Lock()

    def set_bucket_precision(self, bucket: Bucket, precision: str) -> None:
        """Pin one rung's storage precision (call before the rung is built:
        the precision is part of its executable's key and capture)."""
        self._bucket_precisions[bucket] = quant.validate_precision(precision)

    def precision_for_bucket(self, bucket: Bucket) -> str:
        return self._bucket_precisions.get(bucket, self.precision)

    def _rung_stats(self, bucket: Bucket):
        """Synthetic graph stats of one rung: its padded shape at the
        graph's mean sub-row nnz (carried on the ladder)."""
        from repro_torch.plan import cost

        return cost.synthetic_stats(
            rows=bucket.rows,
            n_out_rows=bucket.nodes,
            n_dense_rows=bucket.nodes,
            nnz=max(int(bucket.rows
                        * (self.ladder.mean_row_nnz or self.cfg.tau / 2)), 1),
            tau=self.cfg.tau,
        )

    def plan_for_bucket(self, bucket: Bucket, feature_dim: int) -> SpmmPlan:
        """The one plan a rung is known by (its ``plan_key`` in traces and
        in the feedback store).

        With ``autoplan`` off this is the config's plan.  With it on, the
        rung's synthetic stats go through ``plan.autoplan.choose_plan`` at
        width 1 over ``reference`` and ``cuda`` (the coalesced operand has
        no host ELL to schedule ``cuda_sparse`` from), consulting the
        ``feedback`` store under the rung's bucket key.  Cached per
        (bucket, feature_dim).
        """
        if not self.autoplan:
            return self.plan
        key = (bucket, feature_dim)
        plan = self._bucket_plans.get(key)
        if plan is None:
            from repro_torch.plan.autoplan import choose_plan

            feedback_key = None
            if self.feedback is not None:
                from repro_torch.obs.feedback import bucket_key

                feedback_key = bucket_key(bucket, feature_dim)
            choice = choose_plan(
                self._rung_stats(bucket), feature_dim, self.cfg,
                impls=("reference", "cuda"), schedulable=False,
                device=self.device_model, feedback=self.feedback,
                feedback_key=feedback_key)
            plan = choice.plan.resolve(schedulable=False)
            self._bucket_plans[key] = plan
        return plan

    def layer_plans_for_bucket(self, bucket: Bucket,
                               feature_dim: int) -> List[SpmmPlan]:
        """One plan per layer for one rung's coalesced forward.

        With ``autoplan`` off every layer shares the config's plan.  With
        it on, the rung's synthetic stats go through the pipeline planner
        (``exec.pipeline``), which picks impl, blocks and fusion per layer
        — unless the feedback store has measured the rung: a measurement
        prices the whole coalesced forward, so every layer then runs the
        feedback-informed :meth:`plan_for_bucket`.  An explicit ``fused``
        overrides the fusion both ways.  Cached per (bucket, feature_dim),
        so the choice is made once, before the rung is built.
        """
        key = (bucket, feature_dim)
        plans = self._layer_plans.get(key)
        if plans is None:
            measured = False
            if self.autoplan and self.feedback is not None:
                from repro_torch.obs.feedback import bucket_key

                measured = self.feedback.has_bucket(
                    bucket_key(bucket, feature_dim))
            if measured:
                plans = ([self.plan_for_bucket(bucket, feature_dim)]
                         * self.cfg.n_layers)
            elif self.autoplan:
                from repro_torch.exec.pipeline import plan_pipeline

                pplan = plan_pipeline(self.cfg, self._rung_stats(bucket),
                                      device=self.device_model)
                plans = [lp.spmm.resolve(schedulable=False)
                         for lp in pplan.layers]
            else:
                plans = [self.plan] * self.cfg.n_layers
            if self.fused is not None:
                plans = [dataclasses.replace(p, fused=self.fused)
                         for p in plans]
            self._layer_plans[key] = plans
        return plans

    def _rung_plans(self, bucket: Bucket, feature_dim: int) -> List[SpmmPlan]:
        """The rung's layer plans at the rung's storage precision."""
        prec = self.precision_for_bucket(bucket)
        return [dataclasses.replace(p, precision=prec)
                for p in self.layer_plans_for_bucket(bucket, feature_dim)]

    def uses_slots(self, bucket: Bucket, feature_dim: int) -> bool:
        """Does one of the rung's layers run a fused kernel, which takes
        slot lists (built per request in :meth:`prepare`)?"""
        return any(p.fused and p.effective_impl != "reference"
                   for p in self.layer_plans_for_bucket(bucket, feature_dim))

    def record_batch_dram(self, bucket: Bucket, batch: int,
                          feature_dim: int) -> None:
        """Ledger the modeled DRAM bytes of one coalesced forward.

        A replay never reaches the dispatch's ``record_spmm_dram``; this
        applies the same arithmetic host-side — one record per layer over
        the coalesced block-diagonal operand at the rung's precision and
        layer plans.
        """
        cfg = self.cfg
        rows = int(batch) * bucket.rows
        nodes = int(batch) * bucket.nodes
        f_ins = [feature_dim] + [cfg.hidden_dim] * (cfg.n_layers - 1)
        f_outs = [cfg.hidden_dim] * (cfg.n_layers - 1) + [cfg.out_dim]
        plans = self._rung_plans(bucket, feature_dim)
        for plan, f_in, f_out in zip(plans, f_ins, f_outs):
            if plan.fused and plan.effective_impl != "reference":
                # the intermediate activation's write + read-back (2 * K *
                # F_out elements) never touches DRAM
                ab = quant.activation_bytes(plan.precision)
                LEDGER.record_fused_writeback(2.0 * nodes * f_out * ab)
            else:
                record_combination_dram(plan, nodes, f_in, f_out)
            record_spmm_dram(plan, rows, cfg.tau, nodes, f_out, nodes)

    # ------------------------------------------------------------------
    # Request preparation
    # ------------------------------------------------------------------

    def batch_ladder(self) -> List[int]:
        sizes = [1]
        while sizes[-1] < self.max_batch:
            sizes.append(min(sizes[-1] * 2, self.max_batch))
        return sizes

    def pad_batch(self, n: int) -> int:
        for b in self.batch_ladder():
            if b >= n:
                return b
        raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")

    def chunk_bound(self, bucket: Bucket) -> int:
        """Most slot chunks one request of the rung can have
        (``fv.max_column_chunks`` of its padded table)."""
        return fv.max_column_chunks(bucket.nodes, bucket.rows * self.cfg.tau)

    def prepare(self, sub: SampledSubgraph, features: np.ndarray) -> PaddedRequest:
        """Pad one extracted subgraph to its bucket.

        ``features`` are the subgraph's feature rows in *local* node order
        (i.e. ``global_features[sub.nodes]``).
        """
        if sub.seed_local.size > self.max_seeds:
            raise ValueError(
                f"{sub.seed_local.size} seeds > max_seeds {self.max_seeds}"
            )
        ell = sub.graph.pre.ell
        bucket = self.ladder.bucket_for(sub.n_sub_nodes, ell.padded_rows)
        tau = ell.tau
        cols = np.full((bucket.rows, tau), PAD_COL, dtype=np.int32)
        vals = np.zeros((bucket.rows, tau), dtype=np.float32)
        rmap = np.full((bucket.rows,), -1, dtype=np.int32)
        cols[: ell.padded_rows] = ell.cols
        vals[: ell.padded_rows] = ell.vals
        rmap[: ell.padded_rows] = ell.row_map
        feats = np.zeros((bucket.nodes, features.shape[1]), dtype=np.float32)
        feats[: sub.n_sub_nodes] = features[sub.graph.pre.perm]
        seed_pos = np.full((self.max_seeds,), -1, dtype=np.int32)
        seed_pos[: sub.seed_local.size] = sub.graph.inv[sub.seed_local]
        # Quantize host-side to the rung's storage precision, per
        # cfg.block_rows rows (each layer plan's kernel re-blocks the
        # scales through SpmmOperands.values_for): the padded tail rows
        # are zero, so extra all-zero scale blocks get scale 1.0 and
        # dequantize to the same zeros.  bf16 rounds to nearest even.
        prec = self.precision_for_bucket(bucket)
        scales = None
        if prec == "int8":
            q, s = quant.quantize_values(vals, self.cfg.block_rows)
            vals, scales = q.numpy(), s.numpy()
        elif prec == "bf16":
            vals = torch.from_numpy(vals).to(torch.bfloat16)
        slots = None
        if self.uses_slots(bucket, features.shape[1]):
            if bucket.nodes % fv.XW_TILE_ROWS:
                raise ValueError(
                    f"fused rungs need bucket nodes in whole "
                    f"{fv.XW_TILE_ROWS}-row column groups, got {bucket.nodes}"
                    f" (block_k={self.cfg.block_k})")
            slots = fv.column_slots(cols, bucket.nodes)
            if slots[0].size > self.chunk_bound(bucket):
                raise RuntimeError(
                    f"{slots[0].size} slot chunks > the rung's bound "
                    f"{self.chunk_bound(bucket)}")
        return PaddedRequest(
            bucket=bucket,
            cols=cols,
            vals=vals,
            row_map=rmap,
            feats=feats,
            seed_pos=seed_pos,
            n_seeds=int(sub.seed_local.size),
            scales=scales,
            slots=slots,
        )

    # ------------------------------------------------------------------
    # Coalesced execution
    # ------------------------------------------------------------------

    def _make_forward(self, bucket: Bucket, feature_dim: int):
        """``fwd(params, inputs) -> (batch, max_seeds, out_dim)`` logits of
        the seed rows, over the stacked inputs of :meth:`input_specs`."""
        cfg = self.cfg
        prec = self.precision_for_bucket(bucket)
        layer_plans = self._rung_plans(bucket, feature_dim)
        fused_plans = [p for p in layer_plans
                       if p.fused and p.effective_impl != "reference"]
        nodes_b = bucket.nodes

        def fwd(params, inp: Dict[str, torch.Tensor]) -> torch.Tensor:
            cols, row_map = inp["cols"], inp["row_map"]
            b, rows_b, tau = cols.shape
            # Block-diagonal coalescing: slot i's columns/output rows live
            # in [i * nodes_b, (i+1) * nodes_b), so one launch serves all.
            offs = torch.arange(b, dtype=torch.int32, device=cols.device) * nodes_b
            cols_f = torch.where(
                cols == PAD_COL, PAD_COL, cols + offs[:, None, None]
            ).reshape(b * rows_b, tau)
            rmap_f = torch.where(
                row_map < 0, -1, row_map + offs[:, None]).reshape(b * rows_b)
            # Per-request scale blocks concatenate in row order: each
            # slot's rows are a multiple of block_rows, so the flattened
            # scales stay aligned to the coalesced operand's row blocks.
            scales = inp.get("scales")
            scales_f = None if scales is None else scales.reshape(-1)
            qparams = quant.quantize_params(params, prec, cfg.block_rows)
            operands = SpmmOperands(
                cols=cols_f,
                vals=inp["vals"].reshape(b * rows_b, tau),
                row_map=rmap_f,
                n_out_rows=b * nodes_b,
                scales=scales_f,
                scale_block_rows=None if scales_f is None else cfg.block_rows,
                precision="int8" if scales_f is not None else "f32",
            )
            # every fused layer reads the rung's slot lists, under its own
            # plan's padded X height
            for plan in fused_plans:
                provide_column_slots(
                    plan, operands, b * nodes_b,
                    tuple(inp[name] for name in _SLOT_INPUTS))
            x = inp["feats"].reshape(b * nodes_b, -1)
            for i in range(cfg.n_layers):
                # combination + aggregation under the layer plan's fusion
                # decision: one launch when fused, the classic two when not
                x = execute_layer(layer_plans[i], operands, x,
                                  qparams[f"layer_{i}"],
                                  w_block_rows=cfg.block_rows)
                if i < cfg.n_layers - 1:
                    x = torch.relu(x)
            out = x.reshape(b, nodes_b, cfg.out_dim)
            safe = torch.clamp(inp["seed_pos"], min=0).long()
            return torch.gather(out, 1, safe[:, :, None].expand(
                -1, -1, cfg.out_dim))

        return fwd

    def input_specs(self, bucket: Bucket, batch: int, feature_dim: int) -> dict:
        """``name -> (shape, dtype, padding value)`` of one rung's stacked
        inputs, in the order a run fills them."""
        tau = self.cfg.tau
        prec = self.precision_for_bucket(bucket)
        specs = {
            "cols": ((batch, bucket.rows, tau), torch.int32, PAD_COL),
            "vals": ((batch, bucket.rows, tau), quant.storage_dtype(prec), 0),
        }
        if prec == "int8":
            n_qb = -(-bucket.rows // self.cfg.block_rows)
            specs["scales"] = ((batch, n_qb), torch.float32, 1.0)
        specs.update({
            "row_map": ((batch, bucket.rows), torch.int32, -1),
            "feats": ((batch, bucket.nodes, feature_dim), torch.float32, 0.0),
            "seed_pos": ((batch, self.max_seeds), torch.int32, -1),
        })
        if self.uses_slots(bucket, feature_dim):
            # every chunk past the requests' is empty (start == next start)
            chunks = batch * self.chunk_bound(bucket)
            specs.update({
                "slot_group": ((chunks,), torch.int32, 0),
                "slot_start": ((chunks + 1,), torch.int32, 0),
                "slot_ids": ((batch * bucket.rows * tau,), torch.int32, 0),
            })
        return specs

    def executable(self, params, bucket: Bucket, batch: int, feature_dim: int):
        """The forward of one (bucket, batch, operand-signature) combo: a
        CUDA graph on the card, a closure on the CPU; builds and counts
        one only on first sight."""
        p_sig = tuple(
            (name, k, tuple(v.shape), str(v.dtype))
            for name, layer in sorted(params.items())
            for k, v in sorted(layer.items())
        )
        key = (bucket, batch, feature_dim, self.precision_for_bucket(bucket),
               p_sig)
        exe = self._executables.get(key)
        if exe is None:
            fwd = self._make_forward(bucket, feature_dim)
            if self.device.type == "cuda":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                specs = self.input_specs(bucket, batch, feature_dim)
                exe = _CapturedForward(fwd, params, specs, self.device,
                                       self._pool)
            else:
                exe = _EagerForward(fwd)
            self.compiles += 1
            self._executables[key] = exe
        return exe

    def clear_executables(self) -> int:
        """Drop every executable, with its graph and static buffers, and
        the graph memory pool; returns how many were dropped.
        ``compiles`` keeps counting monotonically, so re-warming after a
        reload is visible to the zero-builds assertions."""
        dropped = len(self._executables)
        self._executables.clear()
        self._pool = None
        return dropped

    def warmup(
        self,
        params,
        feature_dim: int,
        *,
        max_nodes: Optional[int] = None,
        batch_sizes: Optional[List[int]] = None,
    ) -> int:
        """Build the (bucket x batch) grid; returns executables built.

        ``max_nodes`` skips buckets above a node budget (the full-graph rung
        of a huge graph at batch 8 is rarely a real serving shape).
        """
        built = 0
        for bucket in self.ladder.entries:
            if max_nodes is not None and bucket.nodes > max_nodes:
                continue
            for b in batch_sizes or self.batch_ladder():
                before = self.compiles
                self.executable(params, bucket, b, feature_dim)
                built += self.compiles - before
        return built

    def _stack_slots(self, reqs: List[PaddedRequest], bucket: Bucket,
                     specs: dict) -> Dict[str, torch.Tensor]:
        """The requests' slot lists as the coalesced operand's: request
        ``i``'s groups offset by ``i * nodes / 64``, its slot ids by ``i *
        rows * tau``, its chunk starts by the slots before it; then empty
        chunks up to the rung's bound."""
        groups, starts, ids = [], [], []
        n_ids = 0
        per_req_groups = bucket.nodes // fv.XW_TILE_ROWS
        for i, r in enumerate(reqs):
            g, s, sid = r.slots
            groups.append(g + i * per_req_groups)
            starts.append(s[:-1] + n_ids)
            ids.append(sid + i * bucket.rows * self.cfg.tau)
            n_ids += sid.size
        out = {}
        for name, parts, tail in (("slot_group", groups, 0),
                                  ("slot_start", starts, n_ids),
                                  ("slot_ids", ids, 0)):
            shape, dtype, _ = specs[name]
            t = torch.full(shape, tail, dtype=dtype)
            flat = torch.from_numpy(np.concatenate(parts).astype(np.int32))
            t[: flat.numel()] = flat
            out[name] = t
        return out

    def run(self, params, reqs: List[PaddedRequest]) -> List[np.ndarray]:
        """Run one coalesced forward; returns per-request seed logits."""
        if not reqs:
            return []
        bucket = reqs[0].bucket
        if any(r.bucket != bucket for r in reqs):
            raise ValueError("run() requires a single-bucket batch")
        batch = self.pad_batch(len(reqs))
        pad = batch - len(reqs)
        feature_dim = reqs[0].feats.shape[1]
        specs = self.input_specs(bucket, batch, feature_dim)

        def stack(field: str, fill) -> torch.Tensor:
            arrs = [torch.as_tensor(getattr(r, field)) for r in reqs]
            if pad:
                arrs.extend([torch.full_like(arrs[0], fill)] * pad)
            return torch.stack(arrs)

        inputs = {name: stack(name, fill)
                  for name, (_, _, fill) in specs.items()
                  if name not in _SLOT_INPUTS}
        if self.uses_slots(bucket, feature_dim):
            inputs.update(self._stack_slots(reqs, bucket, specs))
        with self._run_lock:
            exe = self.executable(params, bucket, batch, feature_dim)
            out = exe(params, inputs)
            self.calls += 1
        return [out[i, : r.n_seeds] for i, r in enumerate(reqs)]
