"""The single SpMM dispatch path.

:func:`execute` resolves the plan, computes per-sub-row products with the
planned impl and folds vertex-cut splits back with ``segment_accumulate``.
:func:`execute_layer` is the layer-level entry of the GCN forward: a
``fused=True`` plan with a kernel impl runs the one-launch fused layer
(``exec.fused``), anything else runs the combination ``x @ w + b`` and the
aggregation as two steps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.dataflow import plan_kernel_grid
from repro_torch.core.spmm import segment_accumulate
from repro_torch.dist.collectives import LEDGER
from repro_torch.exec import quant
from repro_torch.exec.fused import execute_fused, record_combination_dram
from repro_torch.exec.operands import SpmmOperands
from repro_torch.exec.plan import SpmmPlan
from repro_torch.kernels import flexvector_spmm as fv
from repro_torch.kernels.ref import spmm_ell_ref


def _tile_bitmaps(plan: SpmmPlan, operands: SpmmOperands, f: int):
    """The ``cuda_sparse`` schedule as the kernel's per-row-block k-tile
    bitmaps on the device, planned once per operand and block shape."""
    def build():
        grid = plan_kernel_grid(
            operands.ell, f, block_rows=plan.block_rows, block_k=plan.block_k,
            block_f=plan.block_f,
        )
        bitmaps = fv.schedule_tile_bitmaps(
            grid.pairs[:, 0], grid.pairs[:, 1], grid.first_k,
            grid.n_row_blocks, grid.n_k_tiles)
        return torch.as_tensor(bitmaps, device=operands.device)

    return operands.memo(
        ("tile_bitmaps", plan.block_rows, plan.block_k), build)


def aggregation_args(
    plan: SpmmPlan, operands: SpmmOperands, vals: torch.Tensor,
    dense: torch.Tensor,
) -> Tuple[str, tuple, dict, Tuple[int, int]]:
    """The aggregation kernel a resolved kernel plan launches, and its
    arguments: ``(name, args, kwargs, (r, f))``, where ``(r, f)`` is the
    unpadded output shape to cut the padded result back to."""
    cols_p, vals_p, dense_p, (r, f) = fv.pad_operands(
        operands.cols, vals, dense, plan.block_rows, plan.block_k, plan.block_f
    )
    kw = dict(block_rows=plan.block_rows, block_k=plan.block_k,
              block_f=plan.block_f)
    if plan.effective_impl == "cuda_sparse":
        bitmaps = _tile_bitmaps(plan, operands, f)
        return ("spmm_ell_sparse_grid", (cols_p, vals_p, dense_p, bitmaps),
                kw, (r, f))
    return "spmm_ell_dense_grid", (cols_p, vals_p, dense_p), kw, (r, f)


def sub_row_products(
    plan: SpmmPlan, operands: SpmmOperands, vals: torch.Tensor,
    dense: torch.Tensor,
) -> torch.Tensor:
    """Per-sub-row products ``(R, F)`` with the plan's effective impl.

    Each bounded (sub-)row times the dense operand, *before* the
    partial-sum fold.  The plan must already be resolved.
    """
    impl = plan.effective_impl
    if impl is None:
        raise ValueError("resolve() the plan before dispatch")
    if impl == "reference":
        return spmm_ell_ref(operands.cols, vals, dense)
    name, args, kw, (r, f) = aggregation_args(plan, operands, vals, dense)
    return getattr(fv, name)(*args, **kw)[:r, :f]


def prepare_precision(
    plan: SpmmPlan, operands: SpmmOperands, dense: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, dense)`` in their storage dtype: f32, the only one ported
    (``SpmmPlan`` refuses any other)."""
    return operands.vals.to(torch.float32), dense


def record_spmm_dram(
    plan: SpmmPlan, r: int, tau: int, k: int, f: int, n_out_rows: int
) -> None:
    """Ledger the modeled DRAM bytes one dispatch moves at this precision:
    the ELL table (int32 cols + values + row_map), one pass over the dense
    operand, and the sub-row + folded activation writeback."""
    vb = quant.bytes_per_value(plan.precision)
    ab = quant.activation_bytes(plan.precision)
    sparse = r * tau * (4 + vb) + r * 4
    LEDGER.record(
        "spmm_dram", float(sparse + k * f * ab + (r + n_out_rows) * f * ab)
    )


def execute_layer(
    plan: SpmmPlan, operands: SpmmOperands, x: torch.Tensor, layer: dict
) -> torch.Tensor:
    """One full GCN layer — combination ``x @ w + b`` then aggregation —
    under the plan's fusion decision.

    The reference impl always runs unfused (a gather has no launch to
    fuse).  The unfused combination's DRAM traffic is ledgered so fused
    and unfused byte totals compare honestly.
    """
    plan = plan.resolve(schedulable=operands.schedulable)
    if plan.fused and plan.effective_impl != "reference":
        return execute_fused(plan, operands, x, layer)
    xw = quant.affine(x, layer, plan.precision)
    record_combination_dram(plan, x.shape[0], x.shape[1], int(xw.shape[1]))
    return execute(plan, operands, xw)


def execute(
    plan: SpmmPlan, operands: SpmmOperands, dense: torch.Tensor
) -> torch.Tensor:
    """Run one planned SpMM: ``A @ dense`` for the bounded-row sparse ``A``."""
    plan = plan.resolve(schedulable=operands.schedulable)
    vals, dense = prepare_precision(plan, operands, dense)
    r, tau = operands.cols.shape
    record_spmm_dram(plan, r, tau, dense.shape[0], dense.shape[1],
                     operands.n_out_rows)
    sub = sub_row_products(plan, operands, vals, dense)
    return segment_accumulate(sub, operands.row_map, operands.n_out_rows)
