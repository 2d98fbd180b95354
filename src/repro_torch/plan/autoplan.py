"""Cost-model SpMM plan selection.

The port of ``repro.plan.autoplan``.  Enumerate candidate
:class:`~repro_torch.exec.plan.SpmmPlan`s — impl x block sizes (x storage
precision, x fusion when the layer's input width is given) — score each
with :mod:`repro_torch.plan.cost`, and return the argmin-cost plan.  The
static default (the plan ``exec.plan.plan_for_config`` builds from the
config alone) is always the first candidate, so autoplan never chooses a
plan the cost model ranks worse than it, and ties keep the static choice.
Enumeration order is fixed and the argmin is strict, so the same graph
and device model always yield the same plan.

Under a CUDA kernel model (:data:`~repro_torch.plan.cost.H100`, the
default) the plain PyTorch version (``"reference"``) is a candidate only
when it is the config's own impl: the planner never moves a plan from a
kernel to it.  Under the Pallas model the candidate set is the
reference's.

One card: data-mesh widths above 1 (``mesh=``, ``n_devices > 1``,
``widths``) are ROADMAP item A9, and measured-latency ``feedback`` is A11.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.core.sparse_formats import TiledELL
from repro_torch.dist.topology import viable_mesh_shapes
from repro_torch.exec.plan import VALID_IMPLS, SpmmPlan
from repro_torch.plan import cost as cost_mod

BLOCK_CANDIDATES = (16, 32, 64, 128)


def _unported_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: data-mesh widths above 1 are ROADMAP item A9 (multi-GPU "
        "sharding), not ported yet")


def _unported_feedback() -> NotImplementedError:
    return NotImplementedError(
        "feedback=: measured plan latencies are ROADMAP item A11 "
        "(observability), not ported yet")


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """An autoplan decision with its receipts."""

    plan: SpmmPlan
    cost: cost_mod.CostBreakdown
    static_plan: SpmmPlan
    static_cost: cost_mod.CostBreakdown
    n_candidates: int

    def describe(self) -> str:
        p = self.plan
        return (
            f"{p.impl} rows={p.block_rows} k={p.block_k} f={p.block_f} "
            f"data=1 prec={p.precision} fused={p.fused} "
            f"(bound {self.cost.seconds:.3e}s vs static "
            f"{self.static_cost.seconds:.3e}s)"
        )


def candidate_widths(n_devices: int) -> Tuple[int, ...]:
    """Data-axis widths viable on ``n_devices`` cards, ascending — the
    ``data`` values of every (data, model) factorization."""
    return tuple(sorted({d for d, _ in viable_mesh_shapes(n_devices,
                                                          n_devices)}))


def _as_stats(graph) -> cost_mod.GraphStats:
    if isinstance(graph, cost_mod.GraphStats):
        return graph
    if isinstance(graph, TiledELL):
        return cost_mod.graph_stats_from_ell(graph)
    raise TypeError(
        f"autoplan wants a TiledELL or GraphStats, got {type(graph).__name__}"
    )


def choose_plan(
    graph,
    feature_dim: int,
    cfg=None,
    *,
    impls: Optional[Sequence[str]] = None,
    mesh=None,
    n_devices: Optional[int] = None,
    widths: Optional[Sequence[int]] = None,
    block_candidates: Sequence[int] = BLOCK_CANDIDATES,
    dtype_bytes: int = 4,
    device: Optional[cost_mod.DeviceModel] = None,
    schedulable: Optional[bool] = None,
    precisions: Sequence[str] = ("f32",),
    precision_errors: Optional[dict] = None,
    accuracy_budget: Optional[float] = None,
    f_in: Optional[int] = None,
    feedback=None,
) -> PlanChoice:
    """Pick the argmin-cost plan for one graph + device model.

    ``graph`` is a host :class:`TiledELL` (exact occupancy) or a
    :class:`~repro_torch.plan.cost.GraphStats` (planned shapes, e.g. a
    serving bucket).  ``schedulable`` says whether the execution context
    can plan the ``cuda_sparse`` block-skipping grid host-side; when it
    cannot, that impl is excluded instead of being costed as something it
    will not run.

    ``precisions`` adds a storage-precision search dimension.  A non-f32
    precision is a candidate only when its *measured* end-to-end logit
    error (``precision_errors[p]``) fits ``accuracy_budget``; with a budget
    but no measurement the candidate is excluded.  f32 is always
    admissible and the static f32 default stays the first candidate.

    ``f_in`` (the layer's input width) switches to whole-layer scoring
    and adds fusion as a search dimension: unfused candidates are priced
    as ``spmm_cost + combination_seconds``, fused ones as
    :func:`~repro_torch.plan.cost.fused_layer_cost`, admitted only where
    :func:`~repro_torch.plan.cost.fused_viable` says the launch can run.
    The static plan is scored unfused.
    """
    if feedback is not None:
        raise _unported_feedback()
    if mesh is not None:
        raise _unported_mesh("mesh=")
    device = cost_mod.model_or_default(device)
    stats = _as_stats(graph)
    errs = dict(precision_errors or {})
    errs.setdefault("f32", 0.0)

    def admissible(p: str) -> bool:
        if p == "f32":
            return True
        if accuracy_budget is None:
            return True
        return p in errs and errs[p] <= accuracy_budget

    precs = tuple(p for p in precisions if admissible(p)) or ("f32",)
    if schedulable is None:
        schedulable = stats.ell is not None

    base_impl = getattr(cfg, "spmm_impl", "reference") if cfg else "reference"
    base_blocks = tuple(
        getattr(cfg, name, 128) if cfg else 128
        for name in ("block_rows", "block_k", "block_f")
    )
    if impls is None:
        impls = (base_impl,) + tuple(
            i for i in VALID_IMPLS if i != base_impl)
    if device.cuda is not None:
        # never from a kernel to the plain version
        impls = tuple(i for i in impls
                      if i != "reference" or base_impl == "reference")
    impls = tuple(
        i for i in impls if schedulable or i != "cuda_sparse"
    ) or ("reference",)

    if widths is None:
        widths = candidate_widths(max(n_devices or 1, 1))
    widths = tuple(
        w for w in widths if w == 1 or w <= max(stats.n_sub_rows, 1)
    ) or (1,)
    if max(widths) > 1:
        raise _unported_mesh(f"widths {widths}")

    def blocks_for(base: int) -> Tuple[int, ...]:
        ordered = tuple(sorted(set(block_candidates) | {base}))
        if device.cuda is None:
            return ordered
        # The port's kernels ignore most block sizes, so prices tie often:
        # the config's size goes first, and the strict argmin keeps it
        # when the impl changes too.
        return (base,) + tuple(b for b in ordered if b != base)

    def layer_score(impl, br, bk, bf, precision, fuse):
        """(comparison seconds, CostBreakdown receipt) for one candidate:
        the SpMM alone without ``f_in``, the whole layer with it."""
        if fuse:
            c = cost_mod.fused_layer_cost(
                stats, f_in, feature_dim, impl=impl, block_rows=br,
                block_k=bk, block_f=bf, dtype_bytes=dtype_bytes,
                precision=precision, device=device,
            )
            return c.seconds, c
        c = cost_mod.spmm_cost(
            stats, feature_dim, impl=impl, block_rows=br, block_k=bk,
            block_f=bf, n_shards=1, dtype_bytes=dtype_bytes,
            precision=precision, shard_imbalance=1.0, device=device,
        )
        if f_in is None:
            return c.seconds, c
        comb = cost_mod.combination_seconds(
            stats.n_dense_rows, f_in, feature_dim,
            precision=precision, device=device,
        )
        return c.seconds + comb, c

    def fuse_options(impl, br, bk, bf, precision):
        if f_in is None or impl == "reference":
            return (False,)
        if not cost_mod.fused_viable(
            stats, f_in, block_rows=br, block_k=bk, block_f=bf,
            precision=precision, n_shards=1, device=device, impl=impl,
        ):
            return (False,)
        return (False, True)

    # The static default leads: what plan_for_config(cfg) builds.
    static_impl = base_impl if (
        schedulable or base_impl != "cuda_sparse") else "cuda"
    static_secs, static_cost = layer_score(
        static_impl, *base_blocks, "f32", False)
    best = (static_impl, *base_blocks, "f32", False)
    best_secs, best_cost = static_secs, static_cost

    n_cand = 1
    for impl in impls:
        for br in blocks_for(base_blocks[0]):
            for bk in blocks_for(base_blocks[1]):
                for bf in blocks_for(base_blocks[2]):
                    for _ in widths:
                        for prec in precs:
                            for fuse in fuse_options(impl, br, bk, bf, prec):
                                n_cand += 1
                                s, c = layer_score(impl, br, bk, bf, prec,
                                                   fuse)
                                if s < best_secs:
                                    best = (impl, br, bk, bf, prec, fuse)
                                    best_secs, best_cost = s, c

    impl, br, bk, bf, precision, fused = best
    hot_k_first = True
    if impl == "cuda_sparse" and stats.ell is not None:
        hot_k_first = choose_hot_k_first(
            stats.ell, feature_dim, block_rows=br, block_k=bk, block_f=bf)
    plan = SpmmPlan(
        impl=impl, block_rows=br, block_k=bk, block_f=bf,
        hot_k_first=hot_k_first, precision=precision, fused=fused,
    )
    static_plan = SpmmPlan(
        impl=base_impl, block_rows=base_blocks[0], block_k=base_blocks[1],
        block_f=base_blocks[2],
    )
    return PlanChoice(
        plan=plan, cost=best_cost, static_plan=static_plan,
        static_cost=static_cost, n_candidates=n_cand,
    )


def choose_hot_k_first(
    ell: TiledELL,
    feature_dim: int,
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
) -> bool:
    """Pick the ``cuda_sparse`` k-tile visit order that minimizes dense
    k-tile switches: score both orderings (hot-tiles-first vs natural
    row-major) by counting switches in the planned pair list and keep the
    cheaper one; ties keep ``hot_k_first=True``.  Deterministic."""
    import numpy as np

    from repro_torch.core.dataflow import plan_kernel_grid

    def switches(hot: bool) -> int:
        pairs = plan_kernel_grid(
            ell, feature_dim, block_rows=block_rows, block_k=block_k,
            block_f=block_f, skip_empty=True, hot_k_first=hot,
        ).pairs
        if len(pairs) <= 1:
            return 0
        return int(np.count_nonzero(np.diff(pairs[:, 1]) != 0))

    return switches(True) <= switches(False)


def autoplan(graph, feature_dim: int, cfg=None, **kw) -> SpmmPlan:
    """:func:`choose_plan` without the receipts."""
    return choose_plan(graph, feature_dim, cfg, **kw).plan


# ---------------------------------------------------------------------------
# Serving bucket-ladder growth factor
# ---------------------------------------------------------------------------

GROWTH_CANDIDATES = (1.3, 1.5, 2.0, 4.0)


def choose_ladder_growth(
    stats,
    cfg,
    *,
    base_nodes: int,
    top_nodes: int,
    candidates: Sequence[float] = GROWTH_CANDIDATES,
    feature_dim: Optional[int] = None,
    horizon: int = 256,
    n_probes: int = 33,
    device: Optional[cost_mod.DeviceModel] = None,
) -> float:
    """Pick the serving bucket ladder's growth factor with the cost model.

    A finer ladder pads each request to a tighter rung but multiplies the
    rungs, each of which costs a warmup build and a priming run.  Each
    candidate scores

        E_s[cost(rung(s))]  +  sum_r cost(r) / horizon

    over ``n_probes`` geometric probe sizes between the base and top rung
    (log-uniform request sizes), ``rung(s)`` the smallest rung covering
    ``s`` and ``cost`` one representative SpMM per rung
    (:func:`~repro_torch.plan.cost.bucket_forward_seconds`) over the
    graph's own statistics.  Deterministic: fixed probes, fixed candidate
    order, strict argmin with earlier candidates winning ties.
    """
    from repro_torch.serve.batcher import ladder_rungs

    stats = _as_stats(stats)
    if feature_dim is None:
        feature_dim = max(
            getattr(cfg, "hidden_dim", 128), getattr(cfg, "out_dim", 1))
    rows_factor = stats.rows_per_node
    mean_nnz = stats.mean_row_nnz or cfg.tau / 2

    def rung_cost(nodes: int) -> float:
        rows = -(-int(nodes * rows_factor) // cfg.block_rows) * cfg.block_rows
        return cost_mod.bucket_forward_seconds(
            rows=rows,
            n_out_rows=nodes,
            mean_row_nnz=mean_nnz,
            tau=cfg.tau,
            f_dims=(feature_dim,),
            impl=cfg.spmm_impl,
            block_rows=cfg.block_rows, block_k=cfg.block_k,
            block_f=cfg.block_f, device=device,
        )

    base = min(base_nodes, top_nodes)
    if base >= top_nodes:
        return float(candidates[0])
    ratio = top_nodes / base
    probes = [
        min(int(math.ceil(base * ratio ** (i / (n_probes - 1)))), top_nodes)
        for i in range(n_probes)
    ]

    best_growth, best_score = None, None
    for growth in candidates:
        rungs = ladder_rungs(base, top_nodes, growth, cfg.block_k)
        costs = [rung_cost(n) for n in rungs]
        expected = 0.0
        for s in probes:
            idx = next(i for i, n in enumerate(rungs) if n >= s)
            expected += costs[idx]
        score = expected / len(probes) + sum(costs) / max(horizon, 1)
        if best_score is None or score < best_score:
            best_growth, best_score = growth, score
    return float(best_growth)
