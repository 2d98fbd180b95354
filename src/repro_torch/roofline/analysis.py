"""Roofline analysis of a dry-run cell.

The port of ``repro.roofline.analysis``.  Three terms per (arch x shape x
mesh) cell, each a per-device count over a per-card peak of the device
model (``plan.cost``; the H100 unless ``device=`` says otherwise):

  compute    = FLOPs per device            / peak FLOP/s (bf16)
  memory     = bytes accessed per device   / HBM bytes/s
  collective = collective bytes per device / link bytes/s

The reference parses collective bytes out of the partitioned HLO; the
port has no HLO.  Its counterpart, :class:`CollectiveCounter`, is a
dispatch mode that sees every ``_c10d_functional`` collective a step
issues (DTensor's redistributions, below the DTensor level) and adds the
per-device bytes of each result under the reference's keys;
:func:`collective_bytes` reads them as the reference's record.  The same
mode counts the FLOPs of the local ops the ranks run (each op on a
rank's shard, through ``torch.utils.flop_counter``'s formulas), which is
the per-device count the reference reads from ``cost_analysis``: a
``FlopCounterMode`` above DTensor would count each op once at its global
shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.plan.cost import H100, roofline_seconds

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# ``_c10d_functional`` op -> the reference's collective key
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def _numel(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (list, tuple)):
        return max((_numel(o) for o in out), default=0)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts, while active, the collectives and the local FLOPs of the
    ranks' ops.

    An op on DTensors is let through (``NotImplemented``) so that DTensor
    turns it into local ops and collectives first; those this mode sees
    and counts.  ``bytes[key]`` is the per-device result bytes of each
    collective kind, ``calls[key]`` how many were issued, ``largest[key]``
    the elements of its largest single result, ``flops`` the
    FLOPs of the local ops (matrix products and attention, as
    ``torch.utils.flop_counter`` counts them).
    """

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._flop_registry = flop_registry
        self.reset()

    def reset(self) -> None:
        self.bytes: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
        self.calls: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
        self.largest: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            key = _FUNCOL.get(packet.__name__)
            if key is not None:
                self.bytes[key] += _nbytes(out)
                self.calls[key] += 1
                self.largest[key] = max(self.largest[key], _numel(out))
        elif not func.is_view:
            self.ops += 1
            formula = self._flop_registry.get(packet)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            # eager runs every op unfused: each reads its tensor operands
            # and writes its results once
            self.bytes_accessed += (_nbytes(list(args)) + _nbytes(out)
                                    + _nbytes(list(kwargs.values())))
        return out

    def summary(self) -> Dict[str, object]:
        """:func:`collective_bytes` of this counter."""
        return collective_bytes(self)


def collective_bytes(counted) -> Dict[str, object]:
    """Per-collective-kind result bytes (per device), as the reference's
    ``collective_bytes`` parses them out of the HLO: one entry per kind,
    zeros included, ``"total"`` and ``"op_counts"`` (calls per kind).

    ``counted`` is a :class:`CollectiveCounter` or its ``summary()``.
    """
    if isinstance(counted, CollectiveCounter):
        nbytes, calls = counted.bytes, counted.calls
    else:
        nbytes, calls = counted, counted["op_counts"]
    out: Dict[str, object] = {c: float(nbytes.get(c, 0.0))
                              for c in _COLLECTIVES}
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    out["op_counts"] = {c: int(calls.get(c, 0)) for c in _COLLECTIVES}
    return out


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: float
    useful_flops_ratio: float  # MODEL_FLOPS / (FLOPs per device x chips)

    def bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    chips: int,
    model_flops_total: float,
    device=None,
) -> RooflineTerms:
    """The three terms against ``device``'s peaks (``plan.cost.H100``
    unless given; ``plan.cost.TPU_V5E`` gives the reference's).  The
    field names keep the reference's ``hlo_*`` for the per-device
    counts."""
    compute, memory, collective, dominant = roofline_seconds(
        flops_per_device, bytes_per_device, coll_bytes_per_device,
        device if device is not None else H100)
    total = flops_per_device * chips
    return RooflineTerms(
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        dominant=dominant,
        hlo_flops_per_device=flops_per_device,
        hlo_bytes_per_device=bytes_per_device,
        collective_bytes_per_device=coll_bytes_per_device,
        model_flops_total=model_flops_total,
        useful_flops_ratio=(model_flops_total / total if total else 0.0),
    )


def model_flops(cfg, shape, active_params: Optional[float] = None) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D inference (N active params)."""
    n = active_params if active_params is not None else active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence in the batch
    return 2.0 * n * shape.global_batch


def ssm_time_scan_flops(cfg, shape) -> float:
    """The reference's analytic count of the recurrent time scans'
    per-step state updates (total, all devices), which XLA's cost
    analysis counts once per loop.  The port's loops run every time step
    as ops of their own, so its dry run counts them already and does not
    add this (``launch.dryrun`` records a fix of 0); kept for parity."""
    if shape.kind == "decode":
        return 0.0
    batch = shape.global_batch
    per_step = 0.0
    d = cfg.d_model
    for kind in cfg.pattern:
        mixer = kind.split("+")[0]
        if mixer == "mamba":
            ssm = cfg.ssm
            d_in = (ssm.expand if ssm else 2) * d
            n = ssm.d_state if ssm else 16
            per_step += batch * d_in * n * 6.0
        elif mixer == "mlstm":
            d_in = 2 * d
            hd = d_in // cfg.n_heads
            per_step += batch * cfg.n_heads * hd * hd * 8.0
        elif mixer == "slstm":
            per_step += batch * (2.0 * d * d + 6.0 * d)
    n_periods = cfg.n_periods if cfg.moe is None or not cfg.moe.first_dense \
        else (cfg.n_layers - cfg.moe.first_dense) // len(cfg.pattern)
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd + bwd recompute
    return per_step * (shape.seq_len - 1) * n_periods * mult


def active_param_count(cfg) -> float:
    """Active params per token (MoE: top_k+shared experts only)."""
    total = cfg.param_count()
    if cfg.moe is None:
        return float(total)
    moe = cfg.moe
    w = moe.d_ff_expert or cfg.d_ff
    per_expert = 3 * cfg.d_model * w
    moe_blocks = sum(1 for k in cfg.pattern if k.endswith("+moe")
                     ) * cfg.n_periods
    inactive = (moe.n_experts - moe.top_k) * per_expert * moe_blocks
    return float(total - inactive)
