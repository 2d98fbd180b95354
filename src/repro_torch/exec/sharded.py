"""Sharded SpMM execution over the ``data`` (and optional feature) mesh axes.

The row-wise, product-based dataflow makes vertex-cut partitions the unit
of parallel work: each data shard owns a contiguous slice of the sub-row
axis (``exec.operands.shard_operands``), computes its sub-row products
with the same kernels the single-device path launches, folds them into a
full-height partial output (``core.spmm.segment_accumulate``), and a
collective over the data axis completes the rows
(``dist.collectives``): sub-rows of one node may land on different
shards, and the cross-shard sum is the paper's partial-sum path stretched
across the mesh.

The port runs SPMD, one process per rank of a ``DeviceMesh``
(``launch.mesh.make_data_mesh``).  **The shard contract**: where the
reference returns one global array, each rank returns its own shard of it:

* the whole array under a ``replicated`` output (``out_layout``; the
  epilogue is an all-reduce);
* its contiguous slice of the padded rows under ``row_sharded``: rank
  ``i`` of ``n`` holds rows ``[i * p, (i+1) * p)`` of the
  ``round_up(n_out_rows, n)``-row output, ``p = round_up(n_out_rows, n) /
  n`` (the epilogue is a reduce-scatter; pad rows are exact zeros and sit
  past every real row, so the next layer's combination can run on the
  slice as it is);
* its feature slice under a ``feature_axis``: rank ``j`` of ``m`` holds
  columns ``[j * q, (j+1) * q)`` of the output zero-padded to
  ``round_up(F, m)`` columns, ``q = round_up(F, m) / m``.

``dist.collectives.assemble`` all-gathers a shard into the global array.
A ``row_sharded`` dense operand enters as this rank's row slice and is
all-gathered before the aggregation, which needs every row.

Per-shard operands: each rank's slice is operands of its own
(:meth:`~repro_torch.exec.operands.SpmmOperands.shard`), so ``cuda_sparse``
plans its k-tile bitmaps from its shard's ELL and the fused kernels take
their shard's slot lists; each rank launches its own grid.  (The
reference pads every shard's schedule to one length, because
``shard_map`` runs one program; the port keeps only the reserved
all-padding row block, so the host arrays equal the reference's.)
Stored bf16/int8 values are taken to f32 first and cast or re-quantized
per shard in the shard-major layout, as the reference does: the
nnz-balanced boundaries do not fall on scale blocks.

Every dispatch records the reference's ledger entries, with the
reference's global sizes, so each rank's ledger equals the reference's.

The fold and its collective run in the sub-row output's dtype, as the
reference's ``psum`` does: f32 by default, bf16 under
``out_dtype=torch.bfloat16`` (the partials are rounded to bf16 by the
kernels and summed in bf16), int32 for int8 values beside an int8
operand (exact).  gloo reduces all three on the CPU; no collective is
widened.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.spmm import segment_accumulate
from repro_torch.dist.collectives import (
    LEDGER,
    all_gather_rows,
    segment_psum,
    segment_reduce_scatter,
)
from repro_torch.exec import quant
from repro_torch.exec.operands import SpmmOperands
from repro_torch.exec.plan import SpmmPlan


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def record_traffic(plan: SpmmPlan, n_out: int, n_out_pad: int, f: int,
                   dense_rows: int, act_bytes: int,
                   acc_bytes: int = 4) -> None:
    """Ledger entries of one sharded dispatch, the reference's formulas:
    the epilogue's per-device collective bytes (ring arithmetic: psum
    2(n-1)/n of the buffer, reduce-scatter and all-gather (n-1)/n) and the
    activation writeback under the output layout.  The gathered dense
    operand and the writeback move at the storage width (``act_bytes``),
    the reductions the f32 partials (``acc_bytes``)."""
    n = plan.n_shards
    if n > 1 and plan.dense_layout == "row_sharded":
        LEDGER.record(
            "all_gather", (n - 1) / n * dense_rows * f * act_bytes)
    if n > 1 and plan.out_layout == "row_sharded":
        LEDGER.record(
            "reduce_scatter", (n - 1) / n * n_out_pad * f * acc_bytes)
        LEDGER.record("activation_dram", n_out_pad * f * act_bytes, n=0)
    elif n > 1:
        LEDGER.record("psum", 2.0 * (n - 1) / n * n_out * f * acc_bytes)
        LEDGER.record("activation_dram", n * n_out * f * act_bytes, n=0)


@dataclasses.dataclass(frozen=True)
class Placement:
    """This rank's place on a plan's mesh: its data index ``d`` and
    feature index ``j``, the data axis' process group (None on a 1-wide
    axis), the output's height ``n_out`` and its padded height
    ``n_out_pad``, and whether the output and the dense operand are
    row-sharded."""

    d: int
    j: int
    group: object
    n_out: int
    n_out_pad: int
    row_out: bool
    row_dense: bool


def placement(plan: SpmmPlan, operands: SpmmOperands) -> Placement:
    """Where this rank runs ``plan`` over ``operands``."""
    mesh, n = plan.mesh, plan.n_shards
    if not hasattr(mesh, "get_group"):
        raise TypeError(
            "a sharded plan runs on a DeviceMesh (launch.mesh.make_data_mesh);"
            " an abstract mesh only plans")
    n_sub_rows = operands.memo(
        "n_sub_rows", lambda: int((operands.host_f32()[2] >= 0).sum()))
    if n > max(n_sub_rows, 1):
        raise ValueError(
            f"mesh '{plan.data_axis}' axis is {n} ranks wide but the "
            f"operand has only {n_sub_rows} vertex-cut sub-rows to "
            f"distribute; use a mesh with '{plan.data_axis}' <= "
            f"{max(n_sub_rows, 1)}")
    n_out = operands.n_out_rows
    return Placement(
        d=mesh.get_local_rank(plan.data_axis) if n > 1 else 0,
        j=(mesh.get_local_rank(plan.feature_axis)
           if plan.feature_sharded else 0),
        group=mesh.get_group(plan.data_axis) if n > 1 else None,
        n_out=n_out,
        n_out_pad=_round_up(n_out, n),
        row_out=plan.out_layout == "row_sharded" and n > 1,
        row_dense=plan.dense_layout == "row_sharded" and n > 1,
    )


def rank_operands(plan: SpmmPlan, operands: SpmmOperands, d: int,
                  reserve: bool) -> SpmmOperands:
    """The operands this rank aggregates: its data shard, or, on a 1-wide
    data axis, the whole operand with f32 values (re-quantized per the
    plan, as the reference does)."""
    if plan.n_shards > 1:
        return operands.shard(plan.n_shards, d, plan.block_rows, reserve,
                              plan.shard_split)
    if operands.precision == "f32":
        return operands

    def build():
        return SpmmOperands(
            cols=operands.cols,
            vals=operands.values_for("f32", plan.block_rows)[0],
            row_map=operands.row_map, n_out_rows=operands.n_out_rows,
            ell=operands.ell)

    return operands.memo("f32_operands", build)


def epilogue(sub: torch.Tensor, row_map: torch.Tensor,
             where: Placement) -> torch.Tensor:
    """The fold and, on a sharded data axis, its collective."""
    if where.group is None:
        return segment_accumulate(sub, row_map, where.n_out)
    if where.row_out:
        return segment_reduce_scatter(sub, row_map, where.n_out_pad,
                                      where.group)
    return segment_psum(sub, row_map, where.n_out, where.group)


def execute_sharded(plan: SpmmPlan, operands: SpmmOperands,
                    dense: torch.Tensor) -> torch.Tensor:
    """``A @ dense`` sharded over ``plan.data_axis`` (and optionally
    ``plan.feature_axis``): this rank's shard of the result (the module's
    shard contract), for every impl.  ``dense`` is this rank's row slice
    under ``dense_layout="row_sharded"``, else the whole operand."""
    from repro_torch.exec.dispatch import (prepare_precision,
                                           record_spmm_dram, sub_row_products)

    plan = plan.resolve(schedulable=operands.schedulable)
    where = placement(plan, operands)
    n, m = plan.n_shards, plan.n_feature_shards
    reserve = plan.effective_impl == "cuda_sparse"
    shard = rank_operands(plan, operands, where.d, reserve)
    rows = (operands.sharded(n, plan.block_rows, reserve,
                             plan.shard_split).cols.shape[0]
            if n > 1 else operands.cols.shape[0])

    dense = quant.cast_dense(dense, plan.precision)
    dense_rows = dense.shape[0] * (n if where.row_dense else 1)
    f = dense.shape[1]
    # Feature sharding needs F divisible by the feature-axis width: zero
    # columns contribute zero products.
    f_pad_m = _round_up(f, m)
    record_traffic(plan, where.n_out, where.n_out_pad, f_pad_m,
                   dense_rows, act_bytes=dense.element_size())
    record_spmm_dram(plan, rows, operands.cols.shape[1], dense_rows, f_pad_m,
                     where.n_out)
    if where.row_dense:
        dense = all_gather_rows(dense, where.group)
    if m > 1:
        f_local = f_pad_m // m
        if f_pad_m != f:
            dense = F.pad(dense, (0, f_pad_m - f))
        dense = dense[:, where.j * f_local:(where.j + 1) * f_local]
        dense = dense.contiguous()
    vals, scales, dense = prepare_precision(plan, shard, dense)
    sub = sub_row_products(plan, shard, vals, dense, scales)
    return epilogue(sub, shard.row_map, where)
