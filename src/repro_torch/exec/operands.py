"""The sparse operand of one SpMM: ELL tensors plus the host container.

:class:`SpmmOperands` holds the ELL triple as tensors on the device the
SpMM runs on, and keeps the host :class:`TiledELL` when the caller had
one: that is the handle the block-skipping ``cuda_sparse`` schedules are
planned from.  Schedules are planned once per operand and block shape
and kept on the operand (:meth:`SpmmOperands.memo`), so repeated forward
passes over one graph do not re-plan them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch.core.sparse_formats import TiledELL


@dataclasses.dataclass(frozen=True)
class SpmmOperands:
    """The sparse side of one SpMM: ELL tensors + output row count."""

    cols: torch.Tensor      # (R, tau) int32, PAD_COL padding
    vals: torch.Tensor      # (R, tau) float32
    row_map: torch.Tensor   # (R,) int32, -1 padding
    n_out_rows: int
    ell: Optional[TiledELL] = None
    _memo: Dict[Hashable, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def schedulable(self) -> bool:
        """Host-side grid planning possible (TiledELL available)?"""
        return self.ell is not None

    @property
    def device(self) -> torch.device:
        return self.cols.device

    def memo(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """``build()`` once per ``key`` for this operand, then the kept value."""
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    @staticmethod
    def from_ell(ell: TiledELL, device) -> "SpmmOperands":
        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return SpmmOperands(
            cols=put(ell.cols, torch.int32),
            vals=put(ell.vals, torch.float32),
            row_map=put(ell.row_map, torch.int32),
            n_out_rows=ell.n_orig_rows,
            ell=ell,
        )
