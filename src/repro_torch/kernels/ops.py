"""Public wrapper around the FlexVector aggregation kernels.

The port's copy of ``repro.kernels.ops``: a thin adapter that builds an
:class:`~repro_torch.exec.SpmmPlan` for the requested schedule and calls
the single dispatch path's :func:`~repro_torch.exec.sub_row_products`,
the code every ``spmm_ell`` call runs through, so padding, schedules and
launches exist once.  On the card it launches ``spmm_ell_sparse_grid``
(``skip_empty``) or ``spmm_ell_dense_grid`` at the requested precision
(the ``_scaled`` variants at int8); on CPU tensors the wrappers run their
plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.sparse_formats import TiledELL
from repro_torch.device import resolve_device


def flexvector_spmm(
    ell: TiledELL,
    dense,
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    skip_empty: bool = True,
    hot_k_first: bool = True,
    out_dtype: Optional[torch.dtype] = None,
    precision: str = "f32",
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Compute the sub-row products ``ell @ dense`` with the CUDA kernels.

    Returns the ``(padded_rows, F)`` sub-row outputs; callers apply
    ``segment_accumulate`` to fold vertex-cut splits back together.
    ``skip_empty`` picks the block-skipping schedule (only the occupied
    (row-block, k-tile) pairs of ``plan_kernel_grid``), else the dense
    grid.  ``precision`` selects the storage width (``exec.quant``
    semantics): bf16 casts the values and the dense operand, int8
    quantizes the values per ``block_rows`` row block and dequantizes on
    load; either way the kernels accumulate in f32.  Under f32 a bf16
    ``dense`` stays bf16 beside the f32 values (the kernel wrapper widens
    it to f32, exactly).  ``out_dtype`` goes on the plan, so the kernel
    stores it (f32 or bf16; see ``spmm_ell_dense_grid``).  Runs on the
    card unless ``device`` says otherwise.
    """
    from repro_torch.core.spmm import dense_operand
    from repro_torch.exec import SpmmOperands, SpmmPlan, quant, sub_row_products

    dev = resolve_device(device)
    plan = SpmmPlan(
        impl="cuda_sparse" if skip_empty else "cuda",
        block_rows=block_rows,
        block_k=block_k,
        block_f=block_f,
        hot_k_first=hot_k_first,
        out_dtype=out_dtype,
        precision=precision,
    ).resolve(schedulable=True)
    operands = SpmmOperands.from_ell(ell, dev)
    vals, scales = operands.values_for(precision, block_rows)
    dense = quant.cast_dense(dense_operand(dense, dev), precision)
    return sub_row_products(plan, operands, vals, dense, scales)
