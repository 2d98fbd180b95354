"""High-level SpMM entry point and the vertex-cut partial-sum fold.

``spmm_ell`` computes ``A @ D`` for a preprocessed bounded-row sparse
operand (:class:`TiledELL`) through the single ``repro_torch.exec``
dispatch path.  Sub-rows produced by the vertex-cut are summed back into
their original output row by :func:`segment_accumulate`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.sparse_formats import TiledELL
from repro_torch.device import resolve_device


def spmm_ell(
    ell: TiledELL,
    dense,
    impl: str = "reference",
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    *,
    plan=None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Compute ``A @ dense`` for a preprocessed bounded-row sparse ``A``.

    impl (port names, see ``repro_torch.exec.plan.IMPL_NAMES``):
      * ``reference``   — plain torch gather + segment add.
      * ``cuda``        — the dense-grid FlexVector kernel.
      * ``cuda_sparse`` — the block-skipping FlexVector kernel.

    Runs on ``"cuda"`` unless ``device`` says otherwise.
    """
    from repro_torch.exec import SpmmOperands, SpmmPlan, execute

    dev = resolve_device(device)
    if plan is None:
        plan = SpmmPlan(
            impl=impl, block_rows=block_rows, block_k=block_k, block_f=block_f
        )
    dense = torch.as_tensor(dense, dtype=torch.float32, device=dev)
    return execute(plan, SpmmOperands.from_ell(ell, dev), dense)


def segment_accumulate(
    sub_rows: torch.Tensor, row_map: torch.Tensor, n_out_rows: int
) -> torch.Tensor:
    """Sum vertex-cut sub-row partials back into original output rows.

    Padding sub-rows (``row_map == -1``) land in a spare row that is cut
    off.  On CUDA ``index_add_`` adds with atomics, so the order of the
    partial sums of one row varies from run to run.
    """
    safe = torch.where(row_map >= 0, row_map, n_out_rows).long()
    out = torch.zeros(n_out_rows + 1, sub_rows.shape[1], dtype=sub_rows.dtype,
                      device=sub_rows.device)
    out.index_add_(0, safe, sub_rows)
    return out[:n_out_rows]
