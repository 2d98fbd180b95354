"""High-level SpMM entry point and the vertex-cut partial-sum fold.

``spmm_ell`` computes ``A @ D`` for a preprocessed bounded-row sparse
operand (:class:`TiledELL`) through the single ``repro_torch.exec``
dispatch path; ``spmm_ell_arrays`` is its twin over bare ELL arrays, with
no host container to plan a block-skipping schedule from.  Sub-rows
produced by the vertex-cut are summed back into their original output
row by :func:`segment_accumulate`.  ``spmm_dense_oracle`` is the f64
host oracle the tests hold them to.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.sparse_formats import TiledELL, ell_to_dense
from repro_torch.device import resolve_device
from repro_torch.obs.trace import phase


def spmm_ell(
    ell: TiledELL,
    dense,
    impl: str = "reference",
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    *,
    plan=None,
    mesh=None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Compute ``A @ dense`` for a preprocessed bounded-row sparse ``A``.

    impl (port names, see ``repro_torch.exec.plan.IMPL_NAMES``):
      * ``reference``   — plain torch gather + segment add.
      * ``cuda``        — the dense-grid FlexVector kernel.
      * ``cuda_sparse`` — the block-skipping FlexVector kernel.

    ``plan`` overrides the per-impl arguments with a prebuilt
    :class:`~repro_torch.exec.SpmmPlan`; ``mesh`` is shorthand for
    ``SpmmPlan(mesh=...)`` (a data mesh wider than one rank runs sharded),
    and raises beside ``plan``.  ``dense`` keeps its dtype
    (:func:`dense_operand`): an int8 operand beside an ELL of integer
    values gives the kernels' exact int32 product, a bf16 one runs with the
    values cast to bf16, as in the reference.  Runs on ``"cuda"`` unless
    ``device`` says otherwise.
    """
    from repro_torch.exec import SpmmOperands, SpmmPlan, execute

    dev = resolve_device(device)
    if plan is None:
        plan = SpmmPlan(
            impl=impl, block_rows=block_rows, block_k=block_k,
            block_f=block_f, mesh=mesh,
        )
    elif mesh is not None:
        raise ValueError(
            "pass placement on the plan (SpmmPlan(mesh=...)), not both "
            "plan= and mesh="
        )
    return execute(plan, SpmmOperands.from_ell(ell, dev),
                   dense_operand(dense, dev))


def spmm_ell_arrays(
    cols,                 # (R, tau) int32, PAD_COL padding
    vals,                 # (R, tau) float32 / bfloat16, or int8 with scales
    row_map,              # (R,) int32, -1 padding
    dense,                # (K, F)
    n_out_rows: int,
    impl: str = "reference",
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    *,
    plan=None,
    scales=None,
    scale_block_rows: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """``spmm_ell`` over the ELL arrays themselves.

    Without the host :class:`TiledELL` no block-skipping schedule can be
    planned, so a ``cuda_sparse`` plan resolves to the dense grid, the
    switch recorded on the resolved plan and warned once per process.
    ``scales``/``scale_block_rows`` mark ``vals`` as int8 with symmetric
    per-row-block scales (``exec.quant``); the plan's ``precision`` decides
    how they run.  Runs on ``"cuda"`` unless ``device`` says otherwise.
    """
    from repro_torch.exec import SpmmOperands, SpmmPlan, execute

    dev = resolve_device(device)
    if plan is None:
        plan = SpmmPlan(
            impl=impl, block_rows=block_rows, block_k=block_k, block_f=block_f
        )
    if scales is not None and scale_block_rows is None:
        scale_block_rows = plan.block_rows
    operands = SpmmOperands(
        cols=torch.as_tensor(cols, dtype=torch.int32, device=dev),
        vals=torch.as_tensor(vals, device=dev),
        row_map=torch.as_tensor(row_map, dtype=torch.int32, device=dev),
        n_out_rows=n_out_rows,
        scales=(None if scales is None else
                torch.as_tensor(scales, dtype=torch.float32, device=dev)),
        scale_block_rows=scale_block_rows,
        precision="int8" if scales is not None else "f32",
    )
    return execute(plan, operands, dense_operand(dense, dev))


def dense_operand(dense, device) -> torch.Tensor:
    """The dense operand of an entry point, on ``device``.

    A tensor or a numpy array keeps its dtype, except that a 64-bit one
    is narrowed to 32 bits (f64 to f32, int64 to int32), as the
    reference's ``jnp.asarray`` does; anything else (a list, a scalar) is
    f32.
    """
    if not isinstance(dense, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(dense, dtype=torch.float32, device=device)
    t = torch.as_tensor(dense, device=device)
    narrow = {torch.float64: torch.float32, torch.int64: torch.int32}
    return t.to(narrow[t.dtype]) if t.dtype in narrow else t


def segment_accumulate(
    sub_rows: torch.Tensor, row_map: torch.Tensor, n_out_rows: int
) -> torch.Tensor:
    """Sum vertex-cut sub-row partials back into original output rows.

    Padding sub-rows (``row_map == -1``) land in a spare row that is cut
    off.  On CUDA ``index_add_`` adds with atomics, so the order of the
    partial sums of one row varies from run to run.  It runs in the
    ``gcn.fold`` phase (``obs.trace.phase``).
    """
    with phase("gcn.fold", sub_rows=sub_rows.shape[0], out_rows=n_out_rows,
               width=sub_rows.shape[1]):
        safe = torch.where(row_map >= 0, row_map, n_out_rows).long()
        out = torch.zeros(n_out_rows + 1, sub_rows.shape[1],
                          dtype=sub_rows.dtype, device=sub_rows.device)
        out.index_add_(0, safe, sub_rows)
        return out[:n_out_rows]


def spmm_dense_oracle(ell: TiledELL, dense) -> np.ndarray:
    """``A @ dense`` in f64 on the host: ``A`` densified, then a matmul."""
    return ell_to_dense(ell) @ np.asarray(dense, dtype=np.float64)
