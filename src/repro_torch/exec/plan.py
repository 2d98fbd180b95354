"""SpMM execution plans.

An :class:`SpmmPlan` captures every launch decision once — impl, block
sizes, fusion, placement on a data mesh — so the GCN forward and the entry
points dispatch through one pipeline.  :meth:`SpmmPlan.resolve` pins the
impl that will run: the block-skipping ``cuda_sparse`` schedule needs
host-side occupancy planning over a :class:`TiledELL`, so operands
without one degrade to the dense-grid ``cuda`` kernel, with a warning
once per process and the switch recorded on every resolved plan.

:func:`plan_for_config` builds the static plan from a config, or, given
the host ELL, the cost model's choice (``repro_torch.plan.autoplan``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.dist.topology import axis_sizes
from repro_torch.exec import quant

#: The reference's impl names -> the port's.  The one mapping table.
IMPL_NAMES = {
    "reference": "reference",
    "pallas": "cuda",
    "pallas_sparse": "cuda_sparse",
}
VALID_IMPLS = tuple(IMPL_NAMES.values())
VALID_LAYOUTS = ("replicated", "row_sharded")
#: The ``out_dtype`` values a plan takes (None: the kernels' default, int32
#: beside an integer dense operand, else f32).
VALID_OUT_DTYPES = (None, torch.float32, torch.bfloat16, torch.int32)

# One-time warning registry: reasons already surfaced to the user.
_DEGRADE_WARNED: set = set()


def _warn_once(reason: str) -> None:
    if reason not in _DEGRADE_WARNED:
        _DEGRADE_WARNED.add(reason)
        warnings.warn(reason, RuntimeWarning, stacklevel=4)


def reset_degradation_warnings() -> None:
    """Clear the process-global warn-once registry.

    A degradation is surfaced once per process, not once per call site
    (serving resolves a plan per batcher and per rung), so tests that
    count the warning call this first.
    """
    _DEGRADE_WARNED.clear()


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """Immutable execution plan for one SpMM configuration.

    ``mesh``/``data_axis`` place it: a mesh whose ``data`` axis is wider
    than one rank routes :func:`~repro_torch.exec.dispatch.execute` through
    the sharded path (``exec.sharded``); no mesh, or a 1-wide one, runs on
    one device.  The mesh is the ``DeviceMesh`` of
    ``repro_torch.launch.mesh.make_data_mesh``, or, for planning only, an
    abstract one (``dist.topology.abstract_mesh``).

    ``dense_layout``/``out_layout`` pick the sharded path's prologue and
    epilogue: a ``row_sharded`` output is reduce-scattered (each rank keeps
    its contiguous slice of output rows, the layout a following sharded
    layer consumes), a ``row_sharded`` dense operand is all-gathered before
    the aggregation.  Both act as ``replicated`` on a 1-wide data axis.
    ``feature_axis`` names a second mesh axis that splits the dense
    operand's feature dimension (each feature shard computes every row of
    its F slice; the output stays feature-sharded).  ``shard_split`` places
    the sub-row boundaries (nnz-weighted or uniform).

    ``out_dtype`` is the kernels' accumulator override (the reference's
    name): the dtype the aggregation kernels store (f32 or bf16 beside a
    float dense operand, int32 beside an int8 one) and the fused kernels
    round their f32 sums to (f32 or bf16).  ``None`` keeps the kernels'
    default.  A pair the kernels do not compute raises at launch, naming
    it.  As in the reference, the ``reference`` impl does not read it.

    ``effective_impl``/``degraded_reason`` are the resolution record; they
    are ``None`` on an unresolved plan.
    """

    impl: str = "reference"
    block_rows: int = 128
    block_k: int = 128
    block_f: int = 128
    hot_k_first: bool = True          # sparse-grid schedule: hot k-tiles lead
    out_dtype: Optional[torch.dtype] = None  # kernel accumulator override
    mesh: Optional[object] = None
    data_axis: str = "data"
    shard_split: str = "nnz"          # sub-row split: nnz-weighted | uniform
    dense_layout: str = "replicated"  # dense operand: replicated | row_sharded
    out_layout: str = "replicated"    # epilogue: psum | reduce-scatter
    feature_axis: Optional[str] = None  # mesh axis splitting the F dimension
    precision: str = "f32"            # storage precision (exec.quant)
    fused: bool = False               # fuse combination + aggregation per layer
    effective_impl: Optional[str] = None
    degraded_reason: Optional[str] = None

    def __post_init__(self):
        if self.impl not in VALID_IMPLS:
            raise ValueError(
                f"unknown impl: {self.impl} (expected one of {VALID_IMPLS})"
            )
        if self.shard_split not in ("nnz", "uniform"):
            raise ValueError(
                f"unknown shard_split: {self.shard_split} "
                "(expected 'nnz' or 'uniform')"
            )
        for name in ("dense_layout", "out_layout"):
            if getattr(self, name) not in VALID_LAYOUTS:
                raise ValueError(
                    f"unknown {name}: {getattr(self, name)} "
                    f"(expected one of {VALID_LAYOUTS})"
                )
        quant.validate_precision(self.precision)
        if self.out_dtype not in VALID_OUT_DTYPES:
            raise ValueError(
                f"unknown out_dtype: {self.out_dtype} (expected one of "
                f"{VALID_OUT_DTYPES})"
            )

    # -- placement ----------------------------------------------------------

    def _axis(self, name: Optional[str]) -> int:
        if self.mesh is None or name is None:
            return 1
        return axis_sizes(self.mesh).get(name, 1)

    @property
    def n_shards(self) -> int:
        return self._axis(self.data_axis)

    @property
    def sharded(self) -> bool:
        return self.n_shards > 1

    @property
    def n_feature_shards(self) -> int:
        return self._axis(self.feature_axis)

    @property
    def feature_sharded(self) -> bool:
        return self.n_feature_shards > 1

    # -- resolution ---------------------------------------------------------

    @property
    def resolved(self) -> bool:
        return self.effective_impl is not None

    @property
    def degraded(self) -> bool:
        return self.degraded_reason is not None

    def resolve(self, *, schedulable: bool) -> "SpmmPlan":
        """Pin the impl that will actually run.

        ``schedulable`` says whether a host-side :class:`TiledELL` is
        available for occupancy planning; without one, ``cuda_sparse``
        degrades to the dense grid (recorded, warned once).  Resolving an
        already-resolved plan is a no-op.
        """
        if self.resolved:
            return self
        impl, reason = self.impl, None
        if self.impl == "cuda_sparse" and not schedulable:
            reason = (
                "cuda_sparse degraded to cuda: block-skipping needs "
                "host-side grid planning over a TiledELL, which these "
                "operands do not carry"
            )
            impl = "cuda"
            _warn_once(reason)
        return dataclasses.replace(
            self, effective_impl=impl, degraded_reason=reason
        )


def plan_for_config(
    cfg,
    mesh=None,
    *,
    ell=None,
    feature_dim: Optional[int] = None,
    n_devices: Optional[int] = None,
) -> SpmmPlan:
    """Build a plan from a :class:`~repro_torch.models.gcn.GCNConfig`-like
    object (anything with ``spmm_impl``/``block_rows``/``block_k``/
    ``block_f``).

    Without ``ell`` this is the *static* plan: the config's impl and block
    sizes, placed on ``mesh``.  With ``ell`` (a host
    :class:`~repro_torch.core.sparse_formats.TiledELL`) the choice routes
    through the cost model instead: ``repro_torch.plan.autoplan``
    enumerates impl x block sizes x data-mesh widths and returns the
    argmin-cost plan (never
    costed worse than the static default, which is always a candidate).
    ``feature_dim`` defaults to the config's hidden width — the dominant
    SpMM feature dimension in a GCN stack.
    """
    if ell is not None:
        from repro_torch.plan.autoplan import autoplan  # deferred: no cycle

        return autoplan(
            ell,
            feature_dim or getattr(cfg, "hidden_dim", 128),
            cfg,
            mesh=mesh,
            n_devices=n_devices,
        )
    return SpmmPlan(
        impl=cfg.spmm_impl,
        block_rows=cfg.block_rows,
        block_k=cfg.block_k,
        block_f=cfg.block_f,
        mesh=mesh,
    )
