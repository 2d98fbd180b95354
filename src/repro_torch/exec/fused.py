"""Fused GCN-layer execution: combination + aggregation in one launch.

The unfused path launches the dense combination and the sparse
aggregation separately, so every layer writes the full ``(K, F_out)``
activation ``X @ W + b`` to device memory and reads it back.  Here one
kernel launch per layer computes ``A (X W + b)`` without the intermediate
ever reaching device memory (``kernels.flexvector_spmm.spmm_ell_fused_*``).
The ledger records an explicit 0-byte writeback so fused and unfused runs
stay count-comparable; its formulas are the reference's.

Under bf16/int8 the operands arrive as the unfused path would store them:
values from :meth:`SpmmOperands.values_for`, ``x`` and ``w`` in bf16
(int8 weights dequantized first), ``b`` in f32, and ``X W + b`` rounded to
bf16 inside the kernel (``cast_xw``) where the unfused path rounds it
between its two launches (``quant.cast_dense``).

On a data mesh (``exec.sharded``'s shard contract) each rank runs one
fused launch on its own shard of the sub-rows, with its shard's slot
lists, then the sharded executor's fold and collective; a row-sharded
``X`` is all-gathered before the launch, at ``F_in`` width (the unfused
path gathers the ``F_out``-wide ``X W + b``).  Feature-axis plans run
unfused (``dispatch.execute_layer``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.dataflow import plan_fused_k_schedule
from repro_torch.core.spmm import segment_accumulate
from repro_torch.dist.collectives import LEDGER
from repro_torch.exec import quant
from repro_torch.exec.operands import SpmmOperands
from repro_torch.exec.plan import SpmmPlan
from repro_torch.kernels import flexvector_spmm as fv


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


# -- ledger accounting ------------------------------------------------------


def record_fused_dram(
    plan: SpmmPlan,
    r: int,
    tau: int,
    k: int,
    f_in: int,
    f_out: int,
    n_out_rows: int,
    n_fb: int,
    occ_frac: float,
) -> None:
    """Ledger the modeled DRAM bytes one fused layer dispatch moves: the
    ELL table once (with the int8 scale vector), the layer input ``X``
    once per f-tile over the occupied k-tiles, the weights once, and only
    the aggregated output — the intermediate activation's write +
    read-back never happens (recorded as a 0-byte writeback, the saving
    under ``fused_writeback_saved``)."""
    vb = quant.bytes_per_value(plan.precision)
    ab = quant.activation_bytes(plan.precision)
    sparse = r * tau * (4 + vb) + r * 4
    if plan.precision == "int8":
        sparse += -(-r // plan.block_rows) * 4
    x_read = n_fb * occ_frac * k * f_in * ab
    w_read = f_in * f_out * vb
    out = (r + n_out_rows) * f_out * ab
    LEDGER.record("fused_dram", float(sparse + x_read + w_read + out))
    LEDGER.record_fused_writeback(2.0 * k * f_out * ab)


def record_combination_dram(
    plan: SpmmPlan, k: int, f_in: int, f_out: int
) -> None:
    """Ledger the unfused combination: ``X`` read, ``W`` read, and the
    intermediate ``XW`` written back (its read-back is part of the
    aggregation's ``spmm_dram`` record)."""
    vb = quant.bytes_per_value(plan.precision)
    ab = quant.activation_bytes(plan.precision)
    LEDGER.record(
        "combination_dram",
        float(k * f_in * ab + f_in * f_out * vb + k * f_out * ab),
    )


def _occupied_frac(plan: SpmmPlan, operands: SpmmOperands) -> float:
    """Fraction of k-tiles the fused launch streams ``X`` tiles for."""
    if plan.effective_impl != "cuda_sparse" or operands.ell is None:
        return 1.0

    def build():
        occ = operands.ell.block_occupancy(plan.block_rows, plan.block_k)
        return float(occ.any(axis=0).sum()) / float(max(occ.shape[1], 1))

    return operands.memo(("occupied_frac", plan.block_rows, plan.block_k), build)


# -- execution --------------------------------------------------------------


def _prepare_fused_weights(plan: SpmmPlan, layer: dict, w_block_rows: int):
    """``(w, b_2d, x_cast, xw_cast)`` in the dtypes ``quant.affine`` and
    ``quant.cast_dense`` would produce between the two unfused launches."""
    w, b = layer["w"], layer["b"]
    if plan.precision == "f32":
        return w, b.reshape(1, -1), None, None
    if "w_scale" in layer:
        w = quant.dequantize_values(w, layer["w_scale"], w_block_rows)
    return (w.to(torch.bfloat16), b.to(torch.float32).reshape(1, -1),
            torch.bfloat16, torch.bfloat16)


def _column_slots(operands: SpmmOperands, k: int):
    """:func:`fv.column_slots` of the operand for a ``k``-row ``X``, on its
    device, built once per operand and ``k``."""
    def build():
        cols = operands.ell.cols if operands.ell is not None else operands.cols
        return tuple(torch.as_tensor(a, device=operands.device)
                     for a in fv.column_slots(cols, k))

    return operands.memo(("column_slots", k), build)


def provide_column_slots(plan: SpmmPlan, operands: SpmmOperands, k: int,
                         slots) -> None:
    """Give ``operands`` the fused kernels' slot lists for a ``k``-row
    ``X``, built by the caller, so that :func:`fused_args` never builds
    them from ``operands.cols``: that build reads the table back from the
    device, which a CUDA graph capture forbids.  The serving batcher
    composes them on the host from each request's slot lists."""
    operands.memo(("column_slots", _round_up(k, plan.block_k)), lambda: slots)


def fused_args(
    plan: SpmmPlan, operands: SpmmOperands, x: torch.Tensor, layer: dict,
    w_block_rows: int = quant.QUANT_BLOCK_ROWS,
) -> Tuple[str, tuple, dict, Tuple[int, int]]:
    """The fused kernel a resolved kernel plan launches, and its arguments:
    ``(name, args, kwargs, (r, f_out))`` with operands padded to block
    multiples (``x`` and ``w`` through :func:`fv.pad_fused_operands`),
    ``name`` the :data:`fv.KERNELS` entry (``*_scaled`` for int8 values), the kernel's
    slot lists in ``kwargs["slots"]`` at every precision, ``plan.out_dtype``
    in ``kwargs["out_dtype"]``, and ``(r, f_out)`` the unpadded output
    shape."""
    cols = operands.cols
    vals, scales = operands.values_for(plan.precision, plan.block_rows)
    w, b, x_cast, xw_cast = _prepare_fused_weights(plan, layer, w_block_rows)
    if x_cast is not None:
        x = x.to(x_cast)
    r = cols.shape[0]
    k = x.shape[0]
    f_out = w.shape[1]
    r_pad = _round_up(r, plan.block_rows)
    k_pad = _round_up(k, plan.block_k)
    f_out_pad = _round_up(f_out, plan.block_f)
    if r_pad != r:
        cols = F.pad(cols, (0, 0, 0, r_pad - r), value=fv.PAD_COL)
        vals = F.pad(vals, (0, 0, 0, r_pad - r))
    x, w = fv.pad_fused_operands(x, w, k_pad, f_out_pad)
    if f_out_pad != f_out:
        b = F.pad(b, (0, f_out_pad - f_out))
    args = (cols.contiguous(), vals.contiguous(), x, w, b.contiguous())
    kw = dict(block_rows=plan.block_rows, block_k=plan.block_k,
              block_f=plan.block_f, k_real=k, out_dtype=plan.out_dtype,
              slots=_column_slots(operands, k_pad))
    suffix = ""
    if scales is not None:
        kw["scales"], suffix = scales, "_scaled"
    if xw_cast is not None:
        kw["cast_xw"] = xw_cast
    if plan.effective_impl == "cuda_sparse":
        kb_ids = operands.memo(
            ("fused_k_schedule", plan.block_rows, plan.block_k,
             plan.hot_k_first),
            lambda: torch.as_tensor(
                plan_fused_k_schedule(operands.ell, plan.block_rows,
                                      plan.block_k, plan.hot_k_first),
                dtype=torch.int32, device=operands.device),
        )
        return ("spmm_ell_fused_sparse_grid" + suffix, args + (kb_ids,), kw,
                (r, f_out))
    return "spmm_ell_fused_dense_grid" + suffix, args, kw, (r, f_out)


def execute_fused(
    plan: SpmmPlan, operands: SpmmOperands, x: torch.Tensor, layer: dict,
    *, w_block_rows: int = quant.QUANT_BLOCK_ROWS,
) -> torch.Tensor:
    """One fused GCN layer: ``A @ (X @ W + b)`` in a single launch.

    The plan must carry a kernel impl; ``dispatch.execute_layer`` routes
    the reference impl through the unfused path.  ``layer`` may hold int8
    ``"w"`` + ``"w_scale"`` of ``w_block_rows`` granularity.
    """
    plan = plan.resolve(schedulable=operands.schedulable)
    if plan.feature_sharded:
        raise ValueError(
            "fused execution does not split the feature axis: the fused "
            "launch forms whole rows of X W + b; plan such layers unfused"
        )
    if plan.effective_impl == "reference":
        raise ValueError(
            "the reference impl has no kernel launch to fuse; dispatch "
            "through exec.dispatch.execute_layer, which runs it unfused"
        )
    if plan.sharded:
        return _execute_fused_sharded(plan, operands, x, layer, w_block_rows)
    name, args, kw, (r, f_out) = fused_args(plan, operands, x, layer,
                                            w_block_rows)
    k, f_in = x.shape
    record_fused_dram(
        plan, r, operands.cols.shape[1], k, f_in, f_out, operands.n_out_rows,
        n_fb=args[3].shape[1] // plan.block_f,
        occ_frac=_occupied_frac(plan, operands),
    )
    sub = fv.KERNELS[name](*args, **kw)
    return segment_accumulate(sub[:r, :f_out], operands.row_map,
                              operands.n_out_rows)


def _execute_fused_sharded(
    plan: SpmmPlan, operands: SpmmOperands, x: torch.Tensor, layer: dict,
    w_block_rows: int,
) -> torch.Tensor:
    """One fused launch on this rank's shard of the sub-rows (the unfused
    sharded executor's split, without the reserved block), then its fold
    and collective.  ``x`` is this rank's row slice under
    ``dense_layout="row_sharded"`` (all-gathered here, at ``F_in`` width),
    else the whole layer input."""
    from repro_torch.exec.sharded import epilogue, placement, rank_operands

    where = placement(plan, operands)
    n = plan.n_shards
    shard = rank_operands(plan, operands, where.d, reserve=False)
    rows = operands.sharded(n, plan.block_rows, False,
                            plan.shard_split).cols.shape[0]
    if plan.precision != "f32":
        x = x.to(torch.bfloat16)   # gathered at the storage width
    k = x.shape[0] * (n if where.row_dense else 1)
    f_in = x.shape[1]
    f_out = layer["w"].shape[1]
    record_fused_dram(
        plan, rows, operands.cols.shape[1], k, f_in, f_out, where.n_out,
        n_fb=_round_up(f_out, plan.block_f) // plan.block_f,
        occ_frac=_occupied_frac(plan, operands),
    )
    act_b = x.element_size()
    if where.row_dense:
        LEDGER.record("all_gather", (n - 1) / n * k * f_in * act_b)
    if where.row_out:
        LEDGER.record("reduce_scatter",
                      (n - 1) / n * where.n_out_pad * f_out * 4)
    else:
        LEDGER.record("psum", 2.0 * (n - 1) / n * where.n_out * f_out * 4)
    if where.row_dense:
        from repro_torch.dist.collectives import all_gather_rows

        x = all_gather_rows(x, where.group)
    name, args, kw, (r, f_out) = fused_args(plan, shard, x, layer,
                                            w_block_rows)
    sub = fv.KERNELS[name](*args, **kw)
    return epilogue(sub[:r, :f_out], shard.row_map, where)
