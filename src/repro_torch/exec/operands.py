"""The sparse operand of one SpMM: ELL tensors plus the host container.

:class:`SpmmOperands` holds the ELL triple as tensors on the device the
SpMM runs on, and keeps the host :class:`TiledELL` when the caller had
one: that is the handle the block-skipping ``cuda_sparse`` schedules are
planned from.  Schedules, and the storage-precision copies of the values,
are built once per operand and block shape and kept on the operand
(:meth:`SpmmOperands.memo`), so repeated forward passes over one graph
do not rebuild them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch.core.sparse_formats import TiledELL
from repro_torch.exec import quant


@dataclasses.dataclass(frozen=True)
class SpmmOperands:
    """The sparse side of one SpMM: ELL tensors + output row count.

    ``precision`` says how ``vals`` is *stored* (``exec.quant``
    semantics): f32 values may still run under a bf16/int8 plan (the
    dispatcher casts or quantizes them, once per operand), while int8
    values carry their per-row-block ``scales`` (granularity
    ``scale_block_rows``) from a quantized artifact
    (:meth:`~repro_torch.exec.quant.QuantizedELL.operands`).
    """

    cols: torch.Tensor      # (R, tau) int32, PAD_COL padding
    vals: torch.Tensor      # (R, tau) float32, bfloat16 or int8
    row_map: torch.Tensor   # (R,) int32, -1 padding
    n_out_rows: int
    ell: Optional[TiledELL] = None
    scales: Optional[torch.Tensor] = None   # (ceil(R / sbr),) f32, int8 only
    scale_block_rows: Optional[int] = None
    precision: str = "f32"
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

    def values_for(self, precision: str, block_rows: int):
        """``(vals, scales)`` as a plan of ``precision`` with ``block_rows``
        kernel row blocks runs them: f32 or bf16 values with no scales, or
        int8 values with one f32 scale per kernel row block.

        int8-stored values are used as stored when their scale blocks split
        into kernel row blocks, else dequantized exactly and carried at
        bf16 (one kernel block would need two scales).  f32-stored values
        under int8 are quantized per kernel row block.  Built once per
        operand, precision and block size.
        """
        if precision in ("f32", "bf16"):
            return self._values_as(quant.storage_dtype(precision)), None
        quant.validate_precision(precision)

        def build():
            if self.precision != "int8":
                return quant.quantize_values(self.vals, block_rows)
            scales = quant.align_scales(self.scales, self.scale_block_rows,
                                        block_rows)
            if scales is None:
                return self._values_as(torch.bfloat16), None
            return self.vals, scales.to(torch.float32)

        return self.memo(("int8_values", block_rows), build)

    def _values_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The values in ``dtype``, int8 storage dequantized first."""
        def build():
            if self.precision == "int8":
                return quant.dequantize_values(
                    self.vals, self.scales, self.scale_block_rows).to(dtype)
            return self.vals.to(dtype)

        return self.memo(("values", dtype), build)

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
