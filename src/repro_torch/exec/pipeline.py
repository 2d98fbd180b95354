"""Multi-layer GCN pipeline planning, on one card.

The width-1 port of ``repro.exec.pipeline``.  For a whole
:class:`~repro_torch.models.gcn.GCNConfig` stack it picks, per layer, the
impl and block sizes (``plan.autoplan``) and whether to fuse the layer
into one launch, by an exact DP over the layer chain: each layer's edge
is priced unfused (``plan.cost.spmm_cost`` + the combination) or fused
(``plan.cost.fused_layer_cost``, where ``plan.cost.fused_viable`` admits
it), plus the activation writeback.  The static per-layer default (the
config's impl/blocks, unfused) is always priced as the baseline, and the
chosen pipeline is never priced above it.

At width 1 every layer boundary is replicated.  The row-sharded layouts
the reference chains between sharded layers, a ``mesh`` and
``out_layout="row_sharded"`` are ROADMAP item A9 (multi-GPU sharding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.sparse_formats import TiledELL
from repro_torch.dist.topology import cuda_device_count
from repro_torch.exec import quant
from repro_torch.exec.dispatch import execute_layer
from repro_torch.exec.plan import SpmmPlan
from repro_torch.plan import cost as cost_mod

def _unported_layout(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: row-sharded activations and data meshes are ROADMAP item "
        "A9 (multi-GPU sharding), not ported yet")


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's SpMM plan plus its boundary layouts (``in_layout`` of
    the activation entering the layer, ``out_layout`` of the one it
    emits; both replicated on one card)."""

    spmm: SpmmPlan
    f_in: int
    f_out: int
    in_layout: str = "replicated"
    out_layout: str = "replicated"
    seconds: float = 0.0          # planner's bound for this layer


@dataclasses.dataclass(frozen=True)
class GcnPipelinePlan:
    """A jointly planned multi-layer GCN forward.

    ``cost_seconds`` is the planner's bound for the whole stack;
    ``static_cost_seconds`` the same bound for the static per-layer
    default it is guaranteed never to exceed; ``n_candidates`` the plans
    it priced (each layer's ``choose_plan`` candidates and fusion edges).
    """

    layers: Tuple[LayerPlan, ...]
    n_shards: int = 1
    cost_seconds: float = 0.0
    static_cost_seconds: float = 0.0
    n_candidates: int = 0

    def describe(self) -> str:
        chain = " -> ".join(
            f"L{i}:{lp.spmm.impl}/{lp.out_layout}"
            + ("/fused" if lp.spmm.fused else "")
            for i, lp in enumerate(self.layers)
        )
        return (
            f"data={self.n_shards} {chain} "
            f"(bound {self.cost_seconds:.3e}s vs static "
            f"{self.static_cost_seconds:.3e}s)"
        )


def _layer_dims(cfg, n_layers: Optional[int] = None) -> Tuple[Tuple[int, int], ...]:
    n = n_layers or cfg.n_layers
    dims = [cfg.in_dim] + [cfg.hidden_dim] * (n - 1) + [cfg.out_dim]
    return tuple(zip(dims[:-1], dims[1:]))


def _combination_seconds(n_rows: int, f_in: int, f_out: int, precision: str,
                         device, act_bytes: int = 4,
                         w_bytes: int = 4) -> float:
    """Seconds of the layer's dense ``x @ w``: the reference's roofline
    under the Pallas model, the port's combination under the CUDA kernel
    model (``plan.cost.combination_seconds``)."""
    if device.cuda is not None:
        return cost_mod.combination_seconds(n_rows, f_in, f_out,
                                            precision=precision, device=device)
    flops = 2.0 * n_rows * f_in * f_out
    byts = (float(n_rows) * (f_in + f_out) * act_bytes
            + float(f_in) * f_out * w_bytes)
    return max(flops / device.peak_flops, byts / device.hbm_bw)


def _storage_widths(precision: str, dtype_bytes: int, device):
    """(activation bytes, weight bytes) at ``precision``."""
    if precision == "f32":
        return dtype_bytes, dtype_bytes
    return quant.activation_bytes(precision), device.bytes_per_element(precision)


def layer_seconds(stats, plan: SpmmPlan, f_in: int, f_out: int, *,
                  device=None, dtype_bytes: int = 4) -> float:
    """The planner's price of one layer run under ``plan`` (its impl,
    blocks, precision and fusion), replicated in and out: the fused
    launch, or the combination plus the SpMM; plus the output
    activation's writeback.  The pipeline DP prices every edge with it."""
    device = cost_mod.model_or_default(device)
    precision = plan.precision
    act_bytes, w_bytes = _storage_widths(precision, dtype_bytes, device)
    blocks = dict(impl=plan.impl, block_rows=plan.block_rows,
                  block_k=plan.block_k, block_f=plan.block_f,
                  dtype_bytes=dtype_bytes, precision=precision,
                  device=device)
    if plan.fused:
        core = cost_mod.fused_layer_cost(stats, f_in, f_out, **blocks).seconds
    else:
        core = (cost_mod.spmm_cost(stats, f_out, **blocks).seconds
                + _combination_seconds(stats.n_out_rows, f_in, f_out,
                                       precision, device, act_bytes, w_bytes))
    wb = cost_mod.activation_writeback_bytes(
        stats.n_out_rows, f_out, 1, "replicated", act_bytes) / device.hbm_bw
    return core + wb


def pipeline_seconds(stats, pplan: GcnPipelinePlan, *, device=None,
                     dtype_bytes: int = 4) -> float:
    """The planner's price of a whole forward under ``pplan``: each
    layer's :func:`layer_seconds`, summed."""
    return sum(layer_seconds(stats, lp.spmm, lp.f_in, lp.f_out,
                             device=device, dtype_bytes=dtype_bytes)
               for lp in pplan.layers)


def plan_pipeline(
    cfg,
    graph,
    *,
    mesh=None,
    n_devices: Optional[int] = None,
    n_layers: Optional[int] = None,
    out_layout: str = "replicated",
    device: Optional[cost_mod.DeviceModel] = None,
    dtype_bytes: int = 4,
    precision: str = "f32",
) -> GcnPipelinePlan:
    """Jointly plan every layer of a GCN stack over one graph.

    ``graph`` is a host :class:`TiledELL` or
    :class:`~repro_torch.plan.cost.GraphStats`.  The per-layer impl/blocks
    come from ``plan.autoplan``; then an exact DP over the layer chain
    picks each layer fused or unfused.  Deterministic, and never priced
    above the static per-layer default.  ``precision`` is stamped on
    every per-layer plan and fed to the cost model.  ``device`` defaults
    to ``plan.cost.H100`` (the H100 kernel model).
    """
    from repro_torch.plan.autoplan import candidate_widths, choose_plan

    if mesh is not None:
        raise _unported_layout("mesh=")
    if out_layout != "replicated":
        raise _unported_layout(f"out_layout={out_layout!r}")
    quant.validate_precision(precision)
    device = cost_mod.model_or_default(device)
    stats = (
        cost_mod.graph_stats_from_ell(graph)
        if isinstance(graph, TiledELL) else graph
    )
    dims = _layer_dims(cfg, n_layers)
    # A placed plan needs real cards, so widths are capped by the count.
    widths = tuple(w for w in candidate_widths(max(n_devices or 1, 1))
                   if w == 1 or w <= cuda_device_count())
    if max(widths) > 1:
        raise _unported_layout(f"n_devices={n_devices}")

    def fuse_options(base_plan: SpmmPlan, f_in: int) -> Tuple[bool, ...]:
        """Always unfused; fused too when the impl has a launch to fuse
        and the fused launch can run."""
        if base_plan.impl == "reference":
            return (False,)
        if not cost_mod.fused_viable(
            stats, f_in, block_rows=base_plan.block_rows,
            block_k=base_plan.block_k, block_f=base_plan.block_f,
            precision=precision, n_shards=1, device=device,
            impl=base_plan.impl,
        ):
            return (False,)
        return (False, True)

    def price(plan: SpmmPlan, f_in: int, f_out: int) -> float:
        return layer_seconds(stats, plan, f_in, f_out, device=device,
                             dtype_bytes=dtype_bytes)

    # -- static per-layer baseline: config impl/blocks, unfused.
    static_impl = cfg.spmm_impl if (
        stats.ell is not None or cfg.spmm_impl != "cuda_sparse") else "cuda"
    static_base = SpmmPlan(
        impl=static_impl, block_rows=cfg.block_rows, block_k=cfg.block_k,
        block_f=cfg.block_f, precision=precision,
    )
    static_total = sum(price(static_base, f_in, f_out) for f_in, f_out in dims)

    # Per-layer impl/blocks (the fusion DP below adds terms per layer, so
    # the impl/block argmin is shared by both variants).
    choices = [
        choose_plan(stats, f_out, cfg, widths=(1,), dtype_bytes=dtype_bytes,
                    device=device)
        for _, f_out in dims
    ]
    bases = [c.plan for c in choices]
    n_candidates = sum(c.n_candidates for c in choices)
    # Exact DP over the chain: one state (replicated) per boundary, each
    # layer's edge taken fused or unfused, whichever reaches the next
    # boundary cheaper (ties keep unfused).
    total, layers = 0.0, []
    for i, (f_in, f_out) in enumerate(dims):
        best = None
        for fu in fuse_options(bases[i], f_in):
            plan = dataclasses.replace(bases[i], precision=precision,
                                       fused=fu)
            edge = price(plan, f_in, f_out)
            n_candidates += 1
            if best is None or total + edge < best[0]:
                best = (total + edge, edge, plan)
        total = best[0]
        layers.append(LayerPlan(spmm=best[2], f_in=f_in, f_out=f_out,
                                seconds=best[1]))
    layers = tuple(layers)
    return GcnPipelinePlan(layers=layers, n_shards=1, cost_seconds=total,
                           static_cost_seconds=static_total,
                           n_candidates=n_candidates)


def chain_layouts(n_layers: int) -> Tuple[Tuple[str, str], ...]:
    """The fully chained layout assignment: replicated features in,
    row-sharded at every internal boundary, replicated out — the shape
    whose only full all-reduce is the final epilogue (on a data mesh)."""
    return tuple(
        (
            "replicated" if i == 0 else "row_sharded",
            "replicated" if i == n_layers - 1 else "row_sharded",
        )
        for i in range(n_layers)
    )


def static_pipeline(
    cfg,
    mesh=None,
    *,
    n_layers: Optional[int] = None,
    impl: Optional[str] = None,
    precision: str = "f32",
    fused: bool = False,
) -> GcnPipelinePlan:
    """A :class:`GcnPipelinePlan` from the config alone — no cost model.

    Every layer uses the config's impl/blocks (or ``impl``) at
    ``precision``, replicated in and out; ``fused=True`` stamps every
    layer fused, changing nothing else, so fused-vs-unfused comparisons
    are apples to apples.  A ``mesh`` (and with it the reference's
    ``pipelined`` row-sharded chain) is ROADMAP item A9.
    """
    if mesh is not None:
        raise _unported_layout("mesh=")
    return uniform_pipeline(
        SpmmPlan(impl=impl or cfg.spmm_impl, block_rows=cfg.block_rows,
                 block_k=cfg.block_k, block_f=cfg.block_f,
                 precision=precision, fused=fused),
        _layer_dims(cfg, n_layers))


def uniform_pipeline(spmm: SpmmPlan, dims) -> GcnPipelinePlan:
    """Every layer of ``dims`` (``(f_in, f_out)`` pairs) under the one plan
    ``spmm``, replicated in and out: how ``gcn_forward`` runs a single
    :class:`SpmmPlan`."""
    return GcnPipelinePlan(layers=tuple(
        LayerPlan(spmm=spmm, f_in=f_in, f_out=f_out) for f_in, f_out in dims))


def pipeline_forward(
    params,
    graph,
    features,
    pplan: GcnPipelinePlan,
    device=None,
) -> torch.Tensor:
    """Forward a GCN stack under a :class:`GcnPipelinePlan`: the one layer
    loop behind :func:`repro_torch.models.gcn.gcn_forward`.

    Features are permuted into the preprocessed row order on entry; each
    layer dispatches through its own plan (its impl, blocks, precision
    and fusion; the weights quantized per its ``block_rows``) via
    :func:`~repro_torch.exec.dispatch.execute_layer`, with ReLU between
    layers.  Logits in original node order, on ``device`` (the card
    unless given).
    """
    from repro_torch.device import resolve_device

    if len(pplan.layers) != len(params):
        raise ValueError(
            f"pipeline plan has {len(pplan.layers)} layers, params have "
            f"{len(params)}")
    for lp in pplan.layers:
        if "row_sharded" in (lp.in_layout, lp.out_layout):
            raise _unported_layout("a row-sharded layer boundary")
    dev = resolve_device(device)
    operands, perm, inv = graph.on_device(dev)
    x = torch.as_tensor(features, dtype=torch.float32, device=dev)[perm]
    n_layers = len(pplan.layers)
    for i, lp in enumerate(pplan.layers):
        p = quant.quantize_params({"l": params[f"layer_{i}"]},
                                  lp.spmm.precision, lp.spmm.block_rows)["l"]
        x = execute_layer(lp.spmm, operands, x, p,
                          w_block_rows=lp.spmm.block_rows)
        if i < n_layers - 1:
            x = torch.relu(x)
    return x[inv]
