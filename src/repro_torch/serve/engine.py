"""The GCN serving engine: registry + sampler + micro-batcher, end to end.

The port of ``repro.serve.engine``.  Three request scenarios, all on the
FlexVector SpMM core:

* ``full_forward``  — one full-graph forward (logits for every node),
  through the registry's full-graph step (an eager ``gcn_forward``);
* ``query``         — logits for a handful of seed nodes via k-hop
  fanout-capped extraction (bounded latency, independent of graph size);
* ``query_batch``   — many concurrent seed queries, grouped by shape
  bucket and coalesced into one forward (one CUDA graph replay on the
  card) per bucket chunk: a synchronous facade over the async runtime
  (``repro_torch.runtime``), which :meth:`ServeEngine.runtime` builds for
  open-loop, deadline-aware serving.

Every path records wall-clock latency per request; ``latency_report``
summarizes p50/p99 and throughput (requests/s plus "tok-equivalent"
seed-logits/s — one answered seed node is the serving unit of work).
The engine runs on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.device import resolve_device
from repro_torch.exec import quant
from repro_torch.models.gcn import GCNConfig, init_params
from repro_torch.serve.batcher import BucketLadder, MicroBatcher, PaddedRequest
from repro_torch.serve.registry import ArtifactRegistry, graph_key
from repro_torch.serve.sampler import SubgraphSampler

if TYPE_CHECKING:
    from repro_torch.runtime import ServeRuntime


@dataclasses.dataclass
class LatencyReport:
    scenario: str
    n_requests: int
    p50_ms: float
    p99_ms: float
    req_per_s: float
    tok_per_s: float          # answered seed logits per second

    def line(self) -> str:
        return (
            f"{self.scenario}: {self.n_requests} requests, "
            f"p50 {self.p50_ms:.2f} ms, p99 {self.p99_ms:.2f} ms, "
            f"{self.req_per_s:.1f} req/s, {self.tok_per_s:.1f} tok-equiv/s"
        )


def latency_report(
    scenario: str, latencies_s: Sequence[float], total_seeds: int,
    wall_s: Optional[float] = None,
) -> LatencyReport:
    if len(latencies_s) == 0:
        return LatencyReport(scenario, 0, 0.0, 0.0, 0.0, 0.0)
    lat_ms = np.asarray(latencies_s, dtype=np.float64) * 1e3
    wall = wall_s if wall_s is not None else float(np.sum(lat_ms) / 1e3)
    wall = max(wall, 1e-9)
    return LatencyReport(
        scenario=scenario,
        n_requests=len(lat_ms),
        p50_ms=float(np.percentile(lat_ms, 50)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        req_per_s=len(lat_ms) / wall,
        tok_per_s=total_seeds / wall,
    )


class ServeEngine:
    """Batched GCN inference over one graph."""

    def __init__(
        self,
        adj_norm: CSRMatrix,
        features: np.ndarray,
        cfg: GCNConfig,
        *,
        params=None,
        registry: Optional[ArtifactRegistry] = None,
        ladder: Optional[BucketLadder] = None,
        hops: Optional[int] = None,
        fanout: Optional[int] = 32,
        max_batch: int = 8,
        max_seeds: int = 16,
        base_bucket_nodes: int = 256,
        sampler_seed: int = 0,
        mesh=None,
        autoplan: bool = False,
        ladder_growth=None,
        precision: str = "f32",
        accuracy_budget: float = 0.05,
        fused: Optional[bool] = None,
        feedback=None,
        device=None,
        device_model=None,
    ):
        self.device = resolve_device(device)
        # the cost model every plan and precision pick uses (a
        # plan.cost.DeviceModel; None: the H100 kernel model)
        self.device_model = device_model
        self.cfg = cfg
        self.adj_norm = adj_norm
        self.features = np.asarray(features, dtype=np.float32)
        # the full-graph step's features, moved to the device once
        self._features_dev = torch.as_tensor(self.features, device=self.device)
        self.registry = registry or ArtifactRegistry()
        if params is None:
            params = init_params(cfg, device=self.device)
        self.params = {
            name: {k: torch.as_tensor(v, device=self.device)
                   for k, v in layer.items()}
            for name, layer in params.items()
        }
        # ``precision`` is a fixed storage precision (exec.quant semantics)
        # or "auto": measure each precision's full-graph logit error at
        # warmup and let the cost model pick per rung under
        # ``accuracy_budget``.  Until warmup resolves it, auto serves f32.
        if precision != "auto":
            quant.validate_precision(precision)
        self.precision = precision
        self.accuracy_budget = float(accuracy_budget)
        self.precision_errors: Dict[str, float] = {"f32": 0.0}
        self._static_precision = "f32" if precision == "auto" else precision
        self._graph_key = graph_key(adj_norm, cfg)
        # Full-graph artifact: preprocessed once per content key, persisted.
        # With autoplanning on, the full-graph step runs the pipeline
        # planner's per-layer plans; the config's static plan otherwise.
        self.graph = self.registry.get_or_build(
            adj_norm, cfg, persist=True, key=self._graph_key)
        self._plan_arg = "auto" if autoplan else None
        self._full_step = self._step(self._static_precision)
        self.sampler = SubgraphSampler(
            adj_norm,
            cfg,
            hops=hops,
            fanout=fanout,
            seed=sampler_seed,
            registry=self.registry,
        )
        # With autoplanning on, the ladder's growth factor is a plan
        # decision too unless the caller pinned one; 4 otherwise.
        if ladder_growth is None:
            ladder_growth = "auto" if autoplan else 4
        self.batcher = MicroBatcher(
            cfg,
            ladder
            or BucketLadder.for_graph(self.graph, cfg,
                                      base_nodes=base_bucket_nodes,
                                      growth=ladder_growth,
                                      device_model=device_model),
            max_batch=max_batch,
            max_seeds=max_seeds,
            mesh=mesh,
            autoplan=autoplan,
            precision=self._static_precision,
            fused=fused,
            feedback=feedback,
            device=self.device,
            device_model=device_model,
        )
        # repro_torch.obs.feedback.PlanFeedback (or None): measured per-rung
        # execute latency, consulted by autoplanned rungs at warmup
        # (through the batcher above) and recorded into by runtimes built
        # from :meth:`runtime`.
        self.feedback = feedback
        self.timings: Dict[str, List[float]] = {}
        self.seeds_served: Dict[str, int] = {}
        self.wall: Dict[str, float] = {}

    # ------------------------------------------------------------------

    @staticmethod
    def from_dataset(
        name: str,
        cfg: Optional[GCNConfig] = None,
        hidden_dim: int = 64,
        spmm_impl: str = "reference",
        **kw,
    ) -> "ServeEngine":
        """Build an engine for a named dataset; in/out dims come from the
        dataset spec, ``hidden_dim``/``spmm_impl`` from the caller (or pass
        a full ``cfg`` to control everything)."""
        from repro_torch.graphs.datasets import load_dataset

        ds = load_dataset(name)
        if cfg is None:
            cfg = GCNConfig(
                in_dim=ds.spec.feature_dim,
                hidden_dim=hidden_dim,
                out_dim=ds.spec.classes,
                spmm_impl=spmm_impl,
            )
        return ServeEngine(ds.adj_norm, ds.features, cfg, **kw)

    # ------------------------------------------------------------------

    def warmup(
        self,
        *,
        max_nodes: Optional[int] = None,
        batch_sizes: Optional[List[int]] = None,
    ) -> int:
        """Build the (bucket x batch) executables, and run the full-graph
        step once.

        After this returns, any query whose subgraph fits a built bucket
        runs with zero new executables (``compile_count`` is the proof).
        With ``precision="auto"`` this is also where precision resolves
        (:meth:`_resolve_auto_precision`), before any rung is built.

        With ``max_nodes`` unset and a fanout cap active, warmup derives
        the reachable rungs from the sampler's bounds instead of building
        the whole ladder: at most max_seeds * sum fanout^i (i <= hops)
        nodes can enter a receptive field, and — because the induced
        subgraph keeps every edge among selected nodes — the ELL-row bound
        is taken from the sum over the N globally highest-degree nodes of
        the per-row vertex-cut worst case (<= 2 * ceil(deg/tau) sub-rows).
        Every rung up to the first satisfying *both* bounds is built.
        Uncapped fanout builds every rung.
        """
        if self.precision == "auto":
            self._resolve_auto_precision()
        if max_nodes is None and self.sampler.fanout is not None:
            f, h = self.sampler.fanout, self.sampler.hops
            bound_nodes = min(
                self.batcher.max_seeds * sum(f**i for i in range(h + 1)),
                self.graph.n_nodes,
            )
            per_node = np.sort(-(-self.adj_norm.row_nnz() // self.cfg.tau))[::-1]
            br = self.cfg.block_rows
            bound_rows = -(-int(2 * per_node[:bound_nodes].sum()) // br) * br
            for b in self.batcher.ladder.entries:
                max_nodes = b.nodes
                if b.nodes >= bound_nodes and b.rows >= bound_rows:
                    break
        built = self.batcher.warmup(
            self.params,
            self.features.shape[1],
            max_nodes=max_nodes,
            batch_sizes=batch_sizes,
        )
        self._full_step(self.params, self._features_dev).cpu()
        return built

    @property
    def compile_count(self) -> int:
        """Bucketed-path executables (CUDA graph captures on the card)
        built so far: the recompile monitor."""
        return self.batcher.compiles

    @property
    def graph_key(self) -> str:
        """Content hash identifying this engine's graph."""
        return self._graph_key

    @property
    def resolved_precision(self) -> str:
        """Precision the full-graph step runs at — the configured one, or
        the auto-resolved pick after ``warmup()``."""
        return self._static_precision

    def _step(self, precision: str):
        return self.registry.forward_step(
            self.adj_norm, self.cfg, plan=self._plan_arg,
            precision=precision, device=self.device,
            device_model=self.device_model)

    def full_step_seconds(self, precision: str) -> float:
        """The cost model's price of one full-graph step at ``precision``:
        the pipeline planner's per-layer plans with autoplanning on, the
        config's static plan on every layer otherwise."""
        from repro_torch.exec.pipeline import (pipeline_seconds,
                                               plan_pipeline, static_pipeline)
        from repro_torch.plan import cost

        stats = cost.graph_stats_from_ell(self.graph.pre.ell)
        if self._plan_arg == "auto":
            pplan = plan_pipeline(self.cfg, stats, precision=precision,
                                  device=self.device_model)
        else:
            pplan = static_pipeline(self.cfg, precision=precision)
        return pipeline_seconds(stats, pplan, device=self.device_model)

    def _resolve_auto_precision(self) -> None:
        """Measure each precision's logit error and pin a precision per
        rung.

        The measurement is one full-graph forward per precision through
        the registry's steps on the engine's device, scored with
        :func:`repro_torch.exec.quant.logit_error` against f32.  Each rung
        then takes the precision the cost model prices cheapest
        (``plan.cost.bucket_forward_seconds``) among those whose error
        fits ``accuracy_budget`` — f32 always does, so resolution cannot
        fail.  The full-graph step moves to the admissible precision the
        model prices cheapest for it (:meth:`full_step_seconds`; ties keep
        the wider one).  Idempotent: errors are measured once.
        """
        from repro_torch.plan import cost

        if len(self.precision_errors) <= 1:
            ref = self._full_step(self.params, self._features_dev)
            for p in ("bf16", "int8"):
                out = self._step(p)(self.params, self._features_dev)
                self.precision_errors[p] = quant.logit_error(ref, out)
        admissible = tuple(
            p for p in quant.PRECISIONS
            if self.precision_errors.get(p, float("inf"))
            <= self.accuracy_budget or p == "f32"
        )
        cfg = self.cfg
        f_dims = [cfg.hidden_dim] * (cfg.n_layers - 1) + [cfg.out_dim]
        mean_nnz = self.batcher.ladder.mean_row_nnz or cfg.tau / 2
        for b in self.batcher.ladder.entries:
            best_p, best_s = "f32", None
            for p in admissible:
                s = cost.bucket_forward_seconds(
                    rows=b.rows, n_out_rows=b.nodes, mean_row_nnz=mean_nnz,
                    tau=cfg.tau, f_dims=f_dims, impl=cfg.spmm_impl,
                    block_rows=cfg.block_rows, block_k=cfg.block_k,
                    block_f=cfg.block_f, precision=p,
                    device=self.device_model,
                )
                if best_s is None or s < best_s:
                    best_p, best_s = p, s
            self.batcher.set_bucket_precision(b, best_p)
        full = min(admissible, key=self.full_step_seconds)
        if full != self._static_precision:
            self._full_step = self._step(full)
            self._static_precision = full

    # ------------------------------------------------------------------
    # Scenarios
    # ------------------------------------------------------------------

    def full_forward(self) -> np.ndarray:
        """Full-graph logits for every node (original node order)."""
        t0 = time.perf_counter()
        out = self._full_step(self.params, self._features_dev).cpu().numpy()
        self._record("full", [time.perf_counter() - t0], self.graph.n_nodes)
        return out

    def query(self, seeds: Sequence[int]) -> np.ndarray:
        """Logits for ``seeds`` via sampled-subgraph inference."""
        t0 = time.perf_counter()
        req = self._prepare(seeds)
        out = self.batcher.run(self.params, [req])[0]
        self._record("query", [time.perf_counter() - t0], len(out))
        return out

    def query_batch(self, requests: Sequence[Sequence[int]]) -> List[np.ndarray]:
        """Answer many seed queries, coalescing per shape bucket.

        A synchronous facade over the ``repro_torch.runtime`` machinery:
        every query is submitted (best effort, no deadline) into a
        runtime's queue and the scheduler is drained on the calling
        thread.  With equal priorities and no deadlines the scheduler's
        EDF order is arrival order: each bucket's group closes
        ``max_batch`` at a time while it is full, then what is left of
        each group closes in ``max_batch`` chunks (buckets in first-seen
        order), as the reference's facade closes them.

        Per-request latency spans its own extraction plus the coalesced
        forward it rode in (requests in one chunk share that cost), so the
        latency sum over-counts shared time; throughput uses the actual
        wall clock of the whole call.
        """
        t_call = time.perf_counter()
        rt = self._sync_runtime()
        reqs = [rt.submit(seeds) for seeds in requests]
        rt.drain()
        outputs = [r.future.result() for r in reqs]
        lats = [r.prep_s + (r.exec_s or 0.0) for r in reqs]
        n_seeds = sum(len(o) for o in outputs)
        self._record("batch", lats, n_seeds, wall=time.perf_counter() - t_call)
        return outputs

    def runtime(self, **kw) -> "ServeRuntime":
        """A fresh async runtime over this (ideally warmed) engine; see
        :class:`repro_torch.runtime.ServeRuntime` for the knobs.  An engine
        built with a ``feedback`` store hands it to every runtime (so
        serving keeps feeding the EWMAs warmup consulted) unless the
        caller overrides it here."""
        from repro_torch.runtime import ServeRuntime

        kw.setdefault("feedback", self.feedback)
        return ServeRuntime(self, **kw)

    def _sync_runtime(self) -> "ServeRuntime":
        """The facade's runtime: unbounded (a synchronous batch must never
        shed), never threaded (drained inline per call), and built fresh
        per call so its raw-sample metrics registry stays bounded by one
        batch.  Without a sojourn bound (``max_wait_s=None``, where the
        reference keeps its 50 ms default): the batch is drained in the
        same call, and a bound would only let the time the preparation
        took decide the order in which the batches run."""
        return self.runtime(capacity=None, graph_key=self.graph_key,
                            max_wait_s=None)

    def servable(self, key: Optional[str] = None, **kw):
        raise NotImplementedError(
            "servable(): the servable fleet is ROADMAP item A12, not ported "
            "yet")

    # ------------------------------------------------------------------

    def _prepare(self, seeds: Sequence[int]) -> PaddedRequest:
        sub = self.sampler.extract(seeds)
        return self.batcher.prepare(sub, self.features[sub.nodes])

    def _record(
        self, scenario: str, lats: List[float], seeds: int,
        wall: Optional[float] = None,
    ) -> None:
        self.timings.setdefault(scenario, []).extend(lats)
        self.seeds_served[scenario] = self.seeds_served.get(scenario, 0) + seeds
        # Coalesced calls pass true elapsed time; per-request scenarios'
        # wall is the latency sum (requests ran back to back).
        self.wall[scenario] = self.wall.get(scenario, 0.0) + (
            wall if wall is not None else float(np.sum(lats))
        )

    def report(self, scenario: str, wall_s: Optional[float] = None) -> LatencyReport:
        """Latency/throughput summary; ``wall_s`` overrides the recorded
        per-call wall time (e.g. to include inter-request think time)."""
        return latency_report(
            scenario,
            self.timings.get(scenario, []),
            self.seeds_served.get(scenario, 0),
            wall_s=wall_s if wall_s is not None else self.wall.get(scenario),
        )

    def reset_timings(self) -> None:
        self.timings.clear()
        self.seeds_served.clear()
        self.wall.clear()
