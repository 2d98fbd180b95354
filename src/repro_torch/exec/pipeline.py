"""Multi-layer GCN pipeline planning: keep activations sharded end to end.

The port of ``repro.exec.pipeline``.  For a whole
:class:`~repro_torch.models.gcn.GCNConfig` stack it chooses, jointly, one
data-mesh width, per-layer impl and block sizes (``plan.autoplan``
pinned to that width), whether to fuse each layer into one launch, and
the activation layout at every layer boundary (``replicated`` |
``row_sharded``), by an exact DP over the layer chain: each edge is
priced unfused (``plan.cost.spmm_cost`` + the combination) or fused
(``plan.cost.fused_layer_cost``, where ``plan.cost.fused_viable`` admits
it) under its (dense layout, out layout) pair, plus the layout's
activation writeback.  The input features and the final output are pinned
replicated (or the output to ``out_layout``), so a plan is a shortest
path through a 2-wide lattice.  The static per-layer default (the
config's impl/blocks, replicated, unfused, at the mesh's width) is always
priced as the baseline, and the chosen pipeline is never priced above it.

A row-sharded activation is gathered *after* the next layer's combination
(on ``X W + b``, at that layer's output width) by the unfused path, or
before it (on ``X``, at its input width) by the fused one; either way the
stack's only full all-reduce is the final replicated epilogue.
:func:`pipeline_forward` runs any such plan: each rank holds the shard of
every activation its layout gives it (``exec.sharded``'s shard contract).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.sparse_formats import TiledELL
from repro_torch.dist.collectives import all_gather_columns, all_gather_rows
from repro_torch.dist.topology import axis_sizes
from repro_torch.exec import quant
from repro_torch.exec.dispatch import execute_layer
from repro_torch.exec.plan import SpmmPlan
from repro_torch.obs.trace import phase
from repro_torch.plan import cost as cost_mod

LAYOUTS = ("replicated", "row_sharded")


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's placed SpMM plan plus its boundary layouts:
    ``in_layout`` of the activation entering the layer (and so of the
    dense operand: the SpMM plan's ``dense_layout``), ``out_layout`` of
    the one it emits."""

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
    it priced (each layer's ``choose_plan`` candidates and DP edges, over
    every width).
    """

    layers: Tuple[LayerPlan, ...]
    n_shards: int = 1
    cost_seconds: float = 0.0
    static_cost_seconds: float = 0.0
    n_candidates: int = 0

    @property
    def mesh(self):
        return self.layers[0].spmm.mesh if self.layers else None

    @property
    def n_collective_rounds(self) -> int:
        """Full all-reduces in the stack (reduce-scatters and gathers not
        counted): only layers emitting a replicated output on a sharded
        mesh pay one."""
        return sum(
            1 for lp in self.layers
            if lp.out_layout == "replicated" and lp.spmm.sharded
        )

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


def _combination_seconds(n_rows: int, f_in: int, f_out: int, n_shards: int,
                         in_layout: str, precision: str, device,
                         act_bytes: int = 4, w_bytes: int = 4) -> float:
    """Seconds of the layer's dense ``x @ w`` on one rank: a row-sharded
    input runs it on local rows only.  The reference's roofline under the
    Pallas model, the port's combination under the CUDA kernel model
    (``plan.cost.combination_seconds``)."""
    rows = (
        _round_up(n_rows, n_shards) // n_shards
        if (in_layout == "row_sharded" and n_shards > 1)
        else n_rows
    )
    if device.cuda is not None:
        return cost_mod.combination_seconds(rows, f_in, f_out,
                                            precision=precision, device=device)
    flops = 2.0 * rows * f_in * f_out
    byts = (float(rows) * (f_in + f_out) * act_bytes
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
    blocks, precision, fusion, mesh width and layouts): the fused launch,
    or the combination plus the SpMM; plus this rank's share of the
    output activation's writeback.  The pipeline DP prices every edge
    with it."""
    device = cost_mod.model_or_default(device)
    precision = plan.precision
    width = plan.n_shards
    imb = cost_mod.width_imbalance(stats, width)
    in_l = plan.dense_layout if width > 1 else "replicated"
    out_l = plan.out_layout if width > 1 else "replicated"
    act_bytes, w_bytes = _storage_widths(precision, dtype_bytes, device)
    blocks = dict(impl=plan.impl, block_rows=plan.block_rows,
                  block_k=plan.block_k, block_f=plan.block_f,
                  n_shards=width, out_layout=out_l, dense_layout=in_l,
                  shard_imbalance=imb, dtype_bytes=dtype_bytes,
                  precision=precision, device=device)
    if plan.fused:
        core = cost_mod.fused_layer_cost(stats, f_in, f_out, **blocks).seconds
    else:
        core = (cost_mod.spmm_cost(stats, f_out, **blocks).seconds
                + _combination_seconds(stats.n_out_rows, f_in, f_out, width,
                                       in_l, precision, device, act_bytes,
                                       w_bytes))
    # This rank's share of the layout's activation writeback; the
    # replication factor is what tells the layouts apart here.
    wb = cost_mod.activation_writeback_bytes(
        stats.n_out_rows, f_out, width, out_l, act_bytes
    ) / max(width, 1) / device.hbm_bw
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
    :class:`~repro_torch.plan.cost.GraphStats`.  For each candidate
    data-mesh width (one for the whole stack: row-sharded layouts chain
    only between equal widths) the per-layer impl/blocks come from
    ``plan.autoplan`` pinned to that width, then an exact DP over the
    activation layout at each boundary and each layer's fusion picks the
    chain.  ``mesh`` bounds the widths to {1, its data width}; without
    one they come from ``n_devices``, as far as the process group can
    place them (``plan.autoplan.placeable_widths``).  ``out_layout`` pins
    the layout the stack must emit (``row_sharded`` when the consumer is
    another sharded stage; replicated on a 1-wide candidate).
    Deterministic, and never priced above the static per-layer default.
    ``precision`` is stamped on every per-layer plan and fed to the cost
    model.  ``device`` defaults to ``plan.cost.H100`` (the H100 kernel
    model).
    """
    from repro_torch.plan.autoplan import (_data_mesh, candidate_widths,
                                           choose_plan, placeable_widths)

    quant.validate_precision(precision)
    if out_layout not in LAYOUTS:
        raise ValueError(f"unknown out_layout: {out_layout!r} (expected one "
                         f"of {LAYOUTS})")
    device = cost_mod.model_or_default(device)
    stats = (
        cost_mod.graph_stats_from_ell(graph)
        if isinstance(graph, TiledELL) else graph
    )
    dims = _layer_dims(cfg, n_layers)

    if mesh is not None:
        mesh_width = axis_sizes(mesh).get("data", 1)
        widths: Tuple[int, ...] = tuple(sorted({1, mesh_width}))
    else:
        mesh_width = 1
        # A placed plan needs a real mesh, so candidate widths are capped
        # by what the process group can place.
        widths = placeable_widths(candidate_widths(max(n_devices or 1, 1)))
    widths = tuple(
        w for w in widths if w == 1 or w <= max(stats.n_sub_rows, 1)
    ) or (1,)

    def price(plan: SpmmPlan, f_in: int, f_out: int) -> float:
        return layer_seconds(stats, plan, f_in, f_out, device=device,
                             dtype_bytes=dtype_bytes)

    def fuse_options(base_plan: SpmmPlan, f_in: int,
                     width: int) -> Tuple[bool, ...]:
        """Always unfused; fused too when the impl has a launch to fuse
        and the fused launch can run."""
        if base_plan.impl == "reference":
            return (False,)
        if not cost_mod.fused_viable(
            stats, f_in, block_rows=base_plan.block_rows,
            block_k=base_plan.block_k, block_f=base_plan.block_f,
            precision=precision, n_shards=width, device=device,
            impl=base_plan.impl,
        ):
            return (False,)
        return (False, True)

    # -- static per-layer baseline: config impl/blocks, replicated,
    # unfused, at the width plan_for_config(cfg, mesh) would use.
    static_impl = cfg.spmm_impl if (
        stats.ell is not None or cfg.spmm_impl != "cuda_sparse") else "cuda"
    static_w = mesh_width if mesh_width <= max(stats.n_sub_rows, 1) else 1
    static_base = SpmmPlan(
        impl=static_impl, block_rows=cfg.block_rows, block_k=cfg.block_k,
        block_f=cfg.block_f, mesh=mesh if static_w > 1 else None,
        precision=precision,
    )
    static_total = sum(price(static_base, f_in, f_out) for f_in, f_out in dims)

    best: Optional[GcnPipelinePlan] = None
    n_candidates = 0
    for w in widths:
        w_mesh = _data_mesh(w, mesh, mesh_width)
        # Per-layer impl/blocks at this width (the layout and fusion DP
        # below only adds terms per edge, so the impl/block argmin is
        # shared by every variant).
        choices = [
            choose_plan(stats, f_out, cfg, mesh=w_mesh, widths=(w,),
                        dtype_bytes=dtype_bytes, device=device)
            for _, f_out in dims
        ]
        bases = [c.plan for c in choices]
        n_candidates += sum(c.n_candidates for c in choices)
        states = LAYOUTS if w > 1 else ("replicated",)

        # Exact DP: dist[layout entering layer i]; input replicated; the
        # final layer pinned to the layout the caller asked the stack to
        # emit (replicated on a 1-wide candidate).  Ties keep the first.
        final = out_layout if w > 1 else "replicated"
        dist = {"replicated": (0.0, [])}
        for i, (f_in, f_out) in enumerate(dims):
            last = i == len(dims) - 1
            outs = (final,) if last else states
            nxt: dict = {}
            for in_l, (acc, path) in dist.items():
                for out_l in outs:
                    for fu in fuse_options(bases[i], f_in, w):
                        plan = dataclasses.replace(
                            bases[i], mesh=w_mesh, dense_layout=in_l,
                            out_layout=out_l, precision=precision, fused=fu)
                        edge = price(plan, f_in, f_out)
                        n_candidates += 1
                        s = acc + edge
                        if out_l not in nxt or s < nxt[out_l][0]:
                            nxt[out_l] = (s, path + [(plan, edge)])
            dist = nxt
        total, path = dist[final]
        layers = tuple(
            LayerPlan(spmm=plan, f_in=dims[i][0], f_out=dims[i][1],
                      in_layout=plan.dense_layout,
                      out_layout=plan.out_layout, seconds=edge)
            for i, (plan, edge) in enumerate(path)
        )
        cand = GcnPipelinePlan(
            layers=layers, n_shards=w, cost_seconds=total,
            static_cost_seconds=static_total,
        )
        if best is None or cand.cost_seconds < best.cost_seconds:
            best = cand
    return dataclasses.replace(best, n_candidates=n_candidates)


def chain_layouts(n_layers: int) -> Tuple[Tuple[str, str], ...]:
    """The fully chained layout assignment: replicated features in,
    row-sharded at every internal boundary, replicated out — the shape
    whose only full all-reduce is the final epilogue."""
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
    pipelined: bool = True,
    n_layers: Optional[int] = None,
    impl: Optional[str] = None,
    precision: str = "f32",
    fused: bool = False,
) -> GcnPipelinePlan:
    """A :class:`GcnPipelinePlan` from the config alone — no cost model.

    Every layer uses the config's impl/blocks (or ``impl``) at
    ``precision`` on ``mesh``; ``pipelined=True`` chains
    :func:`chain_layouts` (reduce-scatter between layers, one final
    all-reduce), ``pipelined=False`` is the per-layer all-reduce baseline.
    The two differ only in layouts, and ``fused=True`` stamps every layer
    fused, changing nothing else: like-for-like comparisons.
    """
    dims = _layer_dims(cfg, n_layers)
    width = axis_sizes(mesh).get("data", 1) if mesh is not None else 1
    layouts = (
        chain_layouts(len(dims))
        if (pipelined and width > 1)
        else tuple(("replicated", "replicated") for _ in dims)
    )
    base = SpmmPlan(
        impl=impl or cfg.spmm_impl, block_rows=cfg.block_rows,
        block_k=cfg.block_k, block_f=cfg.block_f, mesh=mesh,
        precision=precision, fused=fused,
    )
    return GcnPipelinePlan(layers=tuple(
        LayerPlan(
            spmm=dataclasses.replace(base, dense_layout=in_l,
                                     out_layout=out_l),
            f_in=f_in, f_out=f_out, in_layout=in_l, out_layout=out_l,
        )
        for (f_in, f_out), (in_l, out_l) in zip(dims, layouts)
    ), n_shards=width)


def uniform_pipeline(spmm: SpmmPlan, dims,
                     out_layout: str = "replicated") -> GcnPipelinePlan:
    """Every layer of ``dims`` (``(f_in, f_out)`` pairs) under the one plan
    ``spmm``: how ``gcn_forward`` runs a single :class:`SpmmPlan`.  The
    final epilogue emits ``out_layout`` (on one rank the layouts
    coincide)."""
    dims = tuple(dims)
    last = len(dims) - 1
    layers = []
    for i, (f_in, f_out) in enumerate(dims):
        plan = spmm
        if i == last and spmm.sharded:
            plan = dataclasses.replace(spmm, out_layout=out_layout)
        layers.append(LayerPlan(spmm=plan, f_in=f_in, f_out=f_out,
                                in_layout=plan.dense_layout,
                                out_layout=plan.out_layout))
    return GcnPipelinePlan(layers=tuple(layers), n_shards=spmm.n_shards)


def _layout(plan: SpmmPlan, which: str) -> str:
    """The row layout a plan's dense operand (``"dense"``) or output
    (``"out"``) really has: row-sharded only on a sharded data axis."""
    layout = plan.dense_layout if which == "dense" else plan.out_layout
    return layout if plan.sharded else "replicated"


def _relayout(x: torch.Tensor, have: str, want: str,
              plan: SpmmPlan) -> torch.Tensor:
    """``x`` moved from row layout ``have`` to ``want`` on ``plan``'s mesh:
    a row shard all-gathered (at its padded height), or this rank's row
    slice of a replicated ``x`` (padded to the mesh) taken."""
    if have == want:
        return x
    group = plan.mesh.get_group(plan.data_axis)
    if want == "replicated":
        return all_gather_rows(x, group)
    n = plan.n_shards
    per = _round_up(x.shape[0], n) // n
    d = plan.mesh.get_local_rank(plan.data_axis)
    if per * n != x.shape[0]:
        x = torch.nn.functional.pad(x, (0, 0, 0, per * n - x.shape[0]))
    return x[d * per:(d + 1) * per]


def _run_device(pplan: GcnPipelinePlan, device) -> torch.device:
    """``device`` if given, else the device of the plan's process mesh,
    else the card."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import mesh_device

    if device is None:
        for lp in pplan.layers:
            if hasattr(lp.spmm.mesh, "get_group"):
                return mesh_device(lp.spmm.mesh)
    return resolve_device(device)


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
    layer dispatches through its own plan (its impl, blocks, precision,
    fusion and placement; the weights quantized per its ``block_rows``)
    via :func:`~repro_torch.exec.dispatch.execute_layer`, with ReLU between
    layers.  A ``row_sharded`` boundary hands the next layer this rank's
    padded row slice, whose combination runs on local rows; an activation
    whose layout differs from what the next layer's plan takes is
    gathered or sliced; a feature-sharded activation is gathered to its
    full width before the next layer.  Logits in original node order, on
    ``device`` (the mesh's device, or the card, unless given), as this
    rank's shard (``exec.sharded``'s contract: under a final feature
    axis its feature slice; under a final ``row_sharded`` layer on a
    sharded mesh its slice of the padded rows, left in the permuted
    order, the form a following sharded stage consumes).
    ``dist.collectives.assemble`` gathers the global logits.

    One inference runs in the ``gcn.forward`` phase (``obs.trace.phase``):
    ``gcn.permute`` on entry, each layer's ``gcn.layer``, the
    ``gcn.activation`` between layers and ``gcn.unpermute`` on exit.
    """
    if len(pplan.layers) != len(params):
        raise ValueError(
            f"pipeline plan has {len(pplan.layers)} layers, params have "
            f"{len(params)}")
    n_layers = len(pplan.layers)
    with phase("gcn.forward", layers=n_layers):
        dev = _run_device(pplan, device)
        operands, perm, inv = graph.on_device(dev)
        with phase("gcn.permute", rows=perm.shape[0]) as ph:
            x = torch.as_tensor(features, dtype=torch.float32,
                                device=dev)[perm]
            ph.set(width=x.shape[1])
        layout = "replicated"
        for i, lp in enumerate(pplan.layers):
            plan = lp.spmm
            p = quant.quantize_params({"l": params[f"layer_{i}"]},
                                      plan.precision, plan.block_rows)["l"]
            x = _relayout(x, layout, _layout(plan, "dense"), plan)
            x = execute_layer(plan, operands, x, p,
                              w_block_rows=plan.block_rows)
            layout = _layout(plan, "out")
            if i < n_layers - 1:
                with phase("gcn.activation", rows=x.shape[0], width=lp.f_out):
                    # the next combination takes all of F
                    if plan.feature_sharded:
                        group = plan.mesh.get_group(plan.feature_axis)
                        x = all_gather_columns(x, group)[:, :lp.f_out]
                    x = torch.relu(x)
        if layout == "row_sharded":
            return x          # permuted order, padded height, this rank's rows
        with phase("gcn.unpermute", rows=inv.shape[0], width=x.shape[1]):
            return x[inv]
