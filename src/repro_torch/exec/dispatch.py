"""The single SpMM dispatch path.

:func:`execute` resolves the plan, computes per-sub-row products with the
planned impl and folds vertex-cut splits back with ``segment_accumulate``;
a plan placed on a data mesh wider than one rank (or with a feature axis)
runs sharded (``exec.sharded``).  :func:`execute_layer` is the
layer-level entry of the GCN forward: a ``fused=True`` plan with a kernel
impl runs the one-launch fused layer (``exec.fused``), anything else runs
the combination ``x @ w + b`` and the aggregation as two steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.dataflow import plan_kernel_grid
from repro_torch.core.spmm import segment_accumulate
from repro_torch.dist.collectives import LEDGER
from repro_torch.exec import quant
from repro_torch.exec.fused import execute_fused, record_combination_dram
from repro_torch.exec.operands import SpmmOperands
from repro_torch.exec.plan import SpmmPlan
from repro_torch.exec.sharded import execute_sharded
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
    dense: torch.Tensor, scales: Optional[torch.Tensor] = None,
) -> Tuple[str, tuple, dict, Tuple[int, int]]:
    """The aggregation kernel a resolved kernel plan launches, and its
    arguments: ``(name, args, kwargs, (r, f))``, where ``name`` is the
    :data:`~repro_torch.kernels.flexvector_spmm.KERNELS` entry (``*_scaled``
    for int8 values) and ``(r, f)`` the unpadded output shape to cut the
    padded result back to.

    Rows are padded to ``plan.block_rows`` and the dense operand's rows to
    ``plan.block_k``, but its columns only to whole 16-byte pieces of its
    storage type (f32 to a multiple of 4, bf16 of 8), which the kernel
    takes as its ``block_f``: it gathers and writes no column of the
    planner's ``plan.block_f`` f-tile beyond those.  ``plan.block_f``
    keeps its meaning for the planner (``plan_kernel_grid``)."""
    block_f = fv.aligned_width(dense.shape[1], dense.dtype)
    cols_p, vals_p, dense_p, (r, f) = fv.pad_operands(
        operands.cols, vals, dense, plan.block_rows, plan.block_k, block_f
    )
    kw = dict(block_rows=plan.block_rows, block_k=plan.block_k,
              block_f=block_f, out_dtype=plan.out_dtype)
    suffix = ""
    if scales is not None:
        kw["scales"], suffix = scales, "_scaled"
    if plan.effective_impl == "cuda_sparse":
        bitmaps = _tile_bitmaps(plan, operands, f)
        return ("spmm_ell_sparse_grid" + suffix,
                (cols_p, vals_p, dense_p, bitmaps), kw, (r, f))
    return ("spmm_ell_dense_grid" + suffix, (cols_p, vals_p, dense_p), kw,
            (r, f))


def sub_row_products(
    plan: SpmmPlan, operands: SpmmOperands, vals: torch.Tensor,
    dense: torch.Tensor, scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sub-row products ``(R, F)`` with the plan's effective impl.

    Each bounded (sub-)row times the dense operand, *before* the
    partial-sum fold.  The plan must already be resolved.  ``scales``
    carries the per-row-block scales of int8 ``vals``; the reference impl
    dequantizes (or widens bf16 values) and gathers in f32.  Its output
    dtype is the reference's gather product's: bf16 where the values and
    the operand are both bf16, else f32, and int32 for integer ones.  It
    sums in f32 (int32) and casts once: bf16 values beside a bf16 operand
    give the f32 sum of their exact products rounded to bf16, as the
    reference's jitted gather does.  It does not read ``plan.out_dtype``
    (nor does the reference's); the kernel impls store it.
    """
    impl = plan.effective_impl
    if impl is None:
        raise ValueError("resolve() the plan before dispatch")
    if impl == "reference":
        if scales is not None:
            vals = quant.dequantize_values(vals, scales, plan.block_rows)
        elif plan.precision != "f32":
            vals = vals.to(torch.float32)
        if dense.dtype.is_floating_point:   # f32 unless both are bf16
            acc = torch.float32
            out_dtype = dense.dtype if vals.dtype == dense.dtype else acc
        else:
            acc = out_dtype = torch.int32
        return spmm_ell_ref(operands.cols, vals, dense,
                            out_dtype=acc).to(out_dtype)
    name, args, kw, (r, f) = aggregation_args(plan, operands, vals, dense,
                                              scales)
    return fv.KERNELS[name](*args, **kw)[:r, :f]


def prepare_precision(
    plan: SpmmPlan, operands: SpmmOperands, dense: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """``(vals, scales, dense)`` in their storage dtypes for the plan's
    precision: values as :meth:`SpmmOperands.values_for` gives them
    (``scales`` per ``plan.block_rows`` block for int8, else ``None``) and
    the dense operand cast to bf16 under bf16/int8.  Under f32 the dense
    operand keeps its dtype and the values are cast to it, as the
    reference's f32 branch does: bf16 values beside a bf16 operand, int8
    beside an int8 one (the kernels' exact int32 product)."""
    vals, scales = operands.values_for(plan.precision, plan.block_rows)
    if plan.precision == "f32" and vals.dtype != dense.dtype:
        vals = operands.values_as(dense.dtype)
    return vals, scales, quant.cast_dense(dense, plan.precision)


def record_spmm_dram(
    plan: SpmmPlan, r: int, tau: int, k: int, f: int, n_out_rows: int
) -> None:
    """Ledger the modeled DRAM bytes one dispatch moves at this precision:
    the ELL table (int32 cols + stored-width values + row_map + the int8
    scale vector), one pass over the dense operand, and the sub-row +
    folded activation writeback at the activation width."""
    vb = quant.bytes_per_value(plan.precision)
    ab = quant.activation_bytes(plan.precision)
    sparse = r * tau * (4 + vb) + r * 4
    if plan.precision == "int8":
        sparse += -(-r // plan.block_rows) * 4
    LEDGER.record(
        "spmm_dram", float(sparse + k * f * ab + (r + n_out_rows) * f * ab)
    )


def execute_layer(
    plan: SpmmPlan, operands: SpmmOperands, x: torch.Tensor, layer: dict,
    *, w_block_rows: int = quant.QUANT_BLOCK_ROWS,
) -> torch.Tensor:
    """One full GCN layer — combination ``x @ w + b`` then aggregation —
    under the plan's fusion decision.

    The reference impl always runs unfused (a gather has no launch to
    fuse), as do feature-sharded plans.  The unfused combination's DRAM
    traffic is ledgered so fused and unfused byte totals compare honestly
    (at the global height: under ``dense_layout="row_sharded"`` ``x`` is
    this rank's row slice, and the combination runs on it alone).
    ``layer`` holds ``"w"``/``"b"`` and, for int8 weights, ``"w_scale"``
    with ``w_block_rows`` granularity (``quant.quantize_params``).

    When a ``repro_torch.obs`` span is active on this thread, the layer
    runs under an ``execute_layer`` child span stamped with the resolved
    plan's attributes, and the ledger records fired inside land on it as
    events.  Not inside a CUDA graph capture: what is captured runs at
    each replay, not now, so no host span is opened for it.  The span is
    host time, not device time: it closes when the layer's launches are
    enqueued, and no synchronize is added for it.
    """
    plan = plan.resolve(schedulable=operands.schedulable)
    span = None
    if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        from repro_torch.obs.trace import start_layer_span  # no cycle

        span = start_layer_span(plan)
    try:
        if (plan.fused and plan.effective_impl != "reference"
                and not plan.feature_sharded):
            return execute_fused(plan, operands, x, layer,
                                 w_block_rows=w_block_rows)
        xw = quant.affine(x, layer, plan.precision, w_block_rows)
        rows = x.shape[0]
        if plan.sharded and plan.dense_layout == "row_sharded":
            rows *= plan.n_shards
        record_combination_dram(plan, rows, x.shape[1], int(xw.shape[1]))
        return execute(plan, operands, xw)
    finally:
        if span is not None:
            span.finish()


def execute(
    plan: SpmmPlan, operands: SpmmOperands, dense: torch.Tensor
) -> torch.Tensor:
    """Run one planned SpMM: ``A @ dense`` for the bounded-row sparse ``A``,
    on one device or, on a data mesh, sharded (this rank's shard of it)."""
    plan = plan.resolve(schedulable=operands.schedulable)
    if plan.sharded or plan.feature_sharded:
        return execute_sharded(plan, operands, dense)
    vals, scales, dense = prepare_precision(plan, operands, dense)
    r, tau = operands.cols.shape
    record_spmm_dram(plan, r, tau, dense.shape[0], dense.shape[1],
                     operands.n_out_rows)
    sub = sub_row_products(plan, operands, vals, dense, scales)
    return segment_accumulate(sub, operands.row_map, operands.n_out_rows)
