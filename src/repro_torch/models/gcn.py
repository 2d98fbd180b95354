"""Full-graph GCN inference on top of the FlexVector SpMM core.

A GCN layer is X' = sigma(A_hat (X W + b)): the combination ``X W + b``
and the aggregation by the preprocessed ``A_hat`` run through
``exec.dispatch.execute_layer`` under the plan's impl and fusion
decision.  The adjacency is preprocessed once per graph (hybrid edge-cut
+ vertex-cut); parameters are plain ``{"layer_i": {"w", "b"}}``
dictionaries of tensors, the layout of the reference's pytree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.preprocessing import PreprocessResult, preprocess
from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.device import resolve_device
from repro_torch.exec import quant
from repro_torch.exec.operands import SpmmOperands
from repro_torch.exec.plan import SpmmPlan, plan_for_config

if TYPE_CHECKING:
    from repro_torch.exec.pipeline import GcnPipelinePlan

Params = Dict[str, Dict[str, torch.Tensor]]
Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    in_dim: int
    hidden_dim: int
    out_dim: int
    n_layers: int = 2
    tau: int = 6
    tile_rows: int = 16
    edge_cut: str = "rcm"
    spmm_impl: str = "reference"   # reference | cuda | cuda_sparse
    block_rows: int = 128
    block_k: int = 128
    block_f: int = 128


@dataclasses.dataclass
class GCNGraph:
    """Preprocessed graph operand shared by all layers.

    The ELL operand and the permutation index tensors are moved to a
    device once, on first use there (:meth:`on_device`).  A pickle holds
    the host arrays only: the placements are rebuilt on first use after
    unpickling.
    """

    pre: PreprocessResult
    n_nodes: int
    inv: Optional[np.ndarray] = None  # inverse edge-cut permutation
    _placed: Dict[torch.device, Tuple[SpmmOperands, torch.Tensor, torch.Tensor]] = (
        dataclasses.field(default_factory=dict, repr=False))

    def __post_init__(self):
        if self.inv is None:
            perm = np.asarray(self.pre.perm)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            self.inv = inv

    def __getstate__(self):
        return dict(self.__dict__, _placed={})

    @staticmethod
    def build(adj_norm: CSRMatrix, cfg: GCNConfig) -> "GCNGraph":
        pre = preprocess(
            adj_norm,
            tau=cfg.tau,
            tile_rows=cfg.tile_rows,
            edge_cut=cfg.edge_cut,
            pad_rows_to=cfg.block_rows,
        )
        return GCNGraph(pre=pre, n_nodes=adj_norm.rows)

    def on_device(
        self, device: torch.device
    ) -> Tuple[SpmmOperands, torch.Tensor, torch.Tensor]:
        """``(operands, perm, inv)`` on ``device``, built once per device."""
        device = torch.device(device)
        if device not in self._placed:
            def index(a):
                return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                       device=device)

            self._placed[device] = (
                SpmmOperands.from_ell(self.pre.ell, device),
                index(self.pre.perm),
                index(self.inv),
            )
        return self._placed[device]


def init_params(
    cfg: GCNConfig,
    generator: Optional[torch.Generator] = None,
    device: Device = None,
) -> Params:
    """He-normal weights and zero biases, drawn on the CPU from
    ``generator`` (seed 0 when none is given) and moved to ``device``.

    ``torch.Generator`` does not reproduce ``jax.random``: tests that
    compare against the reference carry its parameters across with
    :func:`repro_torch.models.convert.params_from_numpy`.
    """
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dims = [cfg.in_dim] + [cfg.hidden_dim] * (cfg.n_layers - 1) + [cfg.out_dim]
    params: Params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn(d_in, d_out, generator=gen) * math.sqrt(2.0 / d_in)
        params[f"layer_{i}"] = {
            "w": w.to(dev),
            "b": torch.zeros(d_out, dtype=torch.float32, device=dev),
        }
    return params


def gcn_forward(
    params: Params,
    graph: GCNGraph,
    features,
    cfg: GCNConfig,
    plan: Union[None, str, SpmmPlan, "GcnPipelinePlan"] = None,
    precision: str = "f32",
    device: Device = None,
    mesh=None,
    device_model=None,
    out_layout: str = "replicated",
) -> torch.Tensor:
    """Full-graph forward pass; logits in original node order.

    ``features`` (array or tensor, original node order) are permuted on
    entry and the output is permuted back on exit.  ``plan`` defaults to
    the static plan of ``cfg``, applied to every layer.  ``plan="auto"``
    hands the whole stack to the cost model: ``exec.pipeline`` picks each
    layer's impl, block sizes and fusion for this graph on
    ``device_model`` (a ``plan.cost.DeviceModel``; the H100 kernel model
    when None); a :class:`~repro_torch.exec.pipeline.GcnPipelinePlan` can
    also be passed directly.  Every plan runs through
    :func:`~repro_torch.exec.pipeline.pipeline_forward`.  Runs on
    ``"cuda"`` unless ``device`` says otherwise; ``params`` must already
    be there.

    ``mesh`` (a ``DeviceMesh`` from ``launch.mesh.make_data_mesh``; every
    rank calls the forward) shards each layer's row-tile grid over its
    ``data`` axis: the static plan of ``cfg`` is placed on it, and under
    ``plan="auto"`` it bounds the widths the planner may pick.  Each rank
    returns its shard of the logits (``exec.sharded``'s shard contract):
    all of them, unless ``out_layout="row_sharded"`` asks for the output
    left row-sharded (this rank's slice of the padded height, in the
    permuted node order, no inverse permutation: the form a following
    sharded stage consumes).  The device defaults to the mesh's.

    ``precision`` (``f32`` | ``bf16`` | ``int8``, ``exec.quant``
    semantics) is stamped on the plan (on every layer's under
    ``plan="auto"``) and quantizes the layer weights per the plan's
    ``block_rows`` rows, so combination and aggregation both run at the
    reduced storage width with f32 accumulation; a plan that already
    carries a non-f32 precision is honoured.
    """
    from repro_torch.exec.pipeline import (GcnPipelinePlan, pipeline_forward,
                                           plan_pipeline, uniform_pipeline)

    quant.validate_precision(precision)
    if device is None and hasattr(mesh, "get_group"):
        from repro_torch.launch.mesh import mesh_device

        device = mesh_device(mesh)
    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(f"unknown plan: {plan!r} (expected 'auto')")
        plan = plan_pipeline(cfg, graph.pre.ell, mesh=mesh,
                             n_layers=len(params), out_layout=out_layout,
                             precision=precision, device=device_model)
    if not isinstance(plan, GcnPipelinePlan):
        if plan is None:
            plan = plan_for_config(cfg, mesh=mesh)
        if precision != "f32" and plan.precision != precision:
            plan = dataclasses.replace(plan, precision=precision)
        plan = uniform_pipeline(plan, [
            tuple(params[f"layer_{i}"]["w"].shape) for i in range(len(params))],
            out_layout=out_layout)
    return pipeline_forward(params, graph, features, plan, device=device)


def gcn_loss(params, graph, features, labels, cfg, mask=None, plan=None,
             device: Device = None) -> torch.Tensor:
    """Mean (or ``mask``-weighted) negative log-likelihood of ``labels``."""
    logits = gcn_forward(params, graph, features, cfg, plan=plan, device=device)
    labels = torch.as_tensor(labels, dtype=torch.long, device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=logits.device)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def gcn_accuracy(params, graph, features, labels, cfg, mask=None, plan=None,
                 device: Device = None) -> torch.Tensor:
    """Share of nodes (or of ``mask`` weight) whose argmax logit is the label."""
    logits = gcn_forward(params, graph, features, cfg, plan=plan, device=device)
    labels = torch.as_tensor(labels, dtype=torch.long, device=logits.device)
    correct = (torch.argmax(logits, -1) == labels).float()
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=logits.device)
        return (correct * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return correct.mean()
