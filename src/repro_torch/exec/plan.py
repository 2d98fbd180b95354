"""SpMM execution plans (single device, f32).

An :class:`SpmmPlan` captures every launch decision once — impl, block
sizes, fusion — so the GCN forward and the entry points dispatch through
one pipeline.  :meth:`SpmmPlan.resolve` pins the impl that will run: the
block-skipping ``cuda_sparse`` schedule needs host-side occupancy planning
over a :class:`TiledELL`, so operands without one degrade to the
dense-grid ``cuda`` kernel, with a warning and the switch recorded on the
resolved plan.

The mesh, ``plan="auto"``, the output layouts and feature-axis sharding
of the reference plan are not ported yet.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.exec import quant

#: The reference's impl names -> the port's.  The one mapping table.
IMPL_NAMES = {
    "reference": "reference",
    "pallas": "cuda",
    "pallas_sparse": "cuda_sparse",
}
VALID_IMPLS = tuple(IMPL_NAMES.values())


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """Immutable execution plan for one SpMM configuration.

    ``effective_impl``/``degraded_reason`` are the resolution record; they
    are ``None`` on an unresolved plan.
    """

    impl: str = "reference"
    block_rows: int = 128
    block_k: int = 128
    block_f: int = 128
    precision: str = "f32"            # storage precision (f32 only here)
    fused: bool = False               # fuse combination + aggregation per layer
    effective_impl: Optional[str] = None
    degraded_reason: Optional[str] = None

    def __post_init__(self):
        if self.impl not in VALID_IMPLS:
            raise ValueError(
                f"unknown impl: {self.impl} (expected one of {VALID_IMPLS})"
            )
        quant.validate_precision(self.precision)

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
        degrades to the dense grid (recorded, and warned).  Resolving an
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
            warnings.warn(reason, RuntimeWarning, stacklevel=3)
        return dataclasses.replace(
            self, effective_impl=impl, degraded_reason=reason
        )


def plan_for_config(cfg) -> SpmmPlan:
    """The static plan of a :class:`~repro_torch.models.gcn.GCNConfig`-like
    object (anything with ``spmm_impl``/``block_rows``/``block_k``/
    ``block_f``)."""
    return SpmmPlan(
        impl=cfg.spmm_impl,
        block_rows=cfg.block_rows,
        block_k=cfg.block_k,
        block_f=cfg.block_f,
    )
