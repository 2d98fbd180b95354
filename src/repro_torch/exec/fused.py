"""Fused GCN-layer execution: combination + aggregation in one launch.

The unfused path launches the dense combination and the sparse
aggregation separately, so every layer writes the full ``(K, F_out)``
activation ``X @ W + b`` to device memory and reads it back.  Here one
kernel launch per layer computes ``A (X W + b)`` without the intermediate
ever reaching device memory (``kernels.flexvector_spmm.spmm_ell_fused_*``).
The ledger records an explicit 0-byte writeback so fused and unfused runs
stay count-comparable; its formulas are the reference's.

Single device only: the sharded fused path waits for the multi-GPU
slice.
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
    ELL table once, the layer input ``X`` once per f-tile over the
    occupied k-tiles, the weights once, and only the aggregated output —
    the intermediate activation's write + read-back never happens
    (recorded as a 0-byte writeback, the saving under
    ``fused_writeback_saved``)."""
    vb = quant.bytes_per_value(plan.precision)
    ab = quant.activation_bytes(plan.precision)
    sparse = r * tau * (4 + vb) + r * 4
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


def fused_args(
    plan: SpmmPlan, operands: SpmmOperands, x: torch.Tensor, layer: dict
) -> Tuple[str, tuple, dict, Tuple[int, int]]:
    """The fused kernel a resolved kernel plan launches, and its arguments:
    ``(name, args, kwargs, (r, f_out))`` with operands padded to block
    multiples and ``(r, f_out)`` the unpadded output shape."""
    cols, vals = operands.cols, operands.vals.to(torch.float32)
    r = cols.shape[0]
    k = x.shape[0]
    w, b = layer["w"], layer["b"].reshape(1, -1)
    f_out = w.shape[1]
    r_pad = _round_up(r, plan.block_rows)
    k_pad = _round_up(k, plan.block_k)
    f_out_pad = _round_up(f_out, plan.block_f)
    if r_pad != r:
        cols = F.pad(cols, (0, 0, 0, r_pad - r), value=fv.PAD_COL)
        vals = F.pad(vals, (0, 0, 0, r_pad - r))
    if k_pad != k:
        x = F.pad(x, (0, 0, 0, k_pad - k))
    if f_out_pad != f_out:
        w = F.pad(w, (0, f_out_pad - f_out))
        b = F.pad(b, (0, f_out_pad - f_out))
    args = tuple(t.contiguous() for t in (cols, vals, x, w, b))
    kw = dict(block_rows=plan.block_rows, block_k=plan.block_k,
              block_f=plan.block_f, k_real=k)
    if plan.effective_impl == "cuda_sparse":
        kb_ids = operands.memo(
            ("fused_k_schedule", plan.block_rows, plan.block_k),
            lambda: torch.as_tensor(
                plan_fused_k_schedule(operands.ell, plan.block_rows,
                                      plan.block_k),
                dtype=torch.int32, device=operands.device),
        )
        return "spmm_ell_fused_sparse_grid", args + (kb_ids,), kw, (r, f_out)
    return "spmm_ell_fused_dense_grid", args, kw, (r, f_out)


def execute_fused(
    plan: SpmmPlan, operands: SpmmOperands, x: torch.Tensor, layer: dict
) -> torch.Tensor:
    """One fused GCN layer: ``A @ (X @ W + b)`` in a single launch.

    The plan must carry a kernel impl; ``dispatch.execute_layer`` routes
    the reference impl through the unfused path.
    """
    plan = plan.resolve(schedulable=operands.schedulable)
    if plan.effective_impl == "reference":
        raise ValueError(
            "the reference impl has no kernel launch to fuse; dispatch "
            "through exec.dispatch.execute_layer, which runs it unfused"
        )
    name, args, kw, (r, f_out) = fused_args(plan, operands, x, layer)
    k, f_in = x.shape
    record_fused_dram(
        plan, r, operands.cols.shape[1], k, f_in, f_out, operands.n_out_rows,
        n_fb=args[3].shape[1] // plan.block_f,
        occ_frac=_occupied_frac(plan, operands),
    )
    sub = getattr(fv, name)(*args, **kw)
    return segment_accumulate(sub[:r, :f_out], operands.row_map,
                              operands.n_out_rows)
