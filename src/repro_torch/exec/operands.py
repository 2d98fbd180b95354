"""The sparse operand of one SpMM: ELL tensors plus the host container.

:class:`SpmmOperands` holds the ELL triple as tensors on the device the
SpMM runs on, and keeps the host :class:`TiledELL` when the caller had
one: that is the handle the block-skipping ``cuda_sparse`` schedules are
planned from.  Schedules, and the storage-precision copies of the values,
are built once per operand and block shape and kept on the operand
(:meth:`SpmmOperands.memo`), so repeated forward passes over one graph
do not rebuild them.

:func:`shard_operands` splits the sub-row axis into contiguous slices, one
per ``data``-axis shard, on the host (the reference's arithmetic, array
for array): a contiguous run of sub-rows is a run of vertex-cut
partitions, and the boundaries are nnz-weighted by default
(``plan.cost.balanced_split_points``), so a hub-owning shard does not hold
most of the nonzeros.  :meth:`SpmmOperands.shard` is one rank's slice as
operands of its own, which memoize their own schedules.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse_formats import PAD_COL, TiledELL
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
    _builds: Dict[Hashable, float] = dataclasses.field(
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
            t0 = time.perf_counter()
            self._memo[key] = build()
            self._builds[key] = time.perf_counter() - t0
        return self._memo[key]

    @property
    def memo_builds(self) -> Dict[Hashable, float]:
        """``key -> host seconds`` of each :meth:`memo` build: what was
        built for this operand (one build a key), and what it cost.  Once
        every shape has run, a forward builds nothing more."""
        return dict(self._builds)

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
            return self.values_as(quant.storage_dtype(precision)), None
        quant.validate_precision(precision)

        def build():
            if self.precision != "int8":
                return quant.quantize_values(self.vals, block_rows)
            scales = quant.align_scales(self.scales, self.scale_block_rows,
                                        block_rows)
            if scales is None:
                return self.values_as(torch.bfloat16), None
            return self.vals, scales.to(torch.float32)

        return self.memo(("int8_values", block_rows), build)

    def values_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The values in ``dtype``, int8 storage dequantized first, built
        once per dtype."""
        def build():
            if self.precision == "int8":
                return quant.dequantize_values(
                    self.vals, self.scales, self.scale_block_rows).to(dtype)
            return self.vals.to(dtype)

        return self.memo(("values", dtype), build)

    def host_f32(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(cols, vals, row_map)`` on the host, the values in f32 (int8
        storage dequantized exactly, bf16 widened), built once."""
        def build():
            def host(a):
                return a.detach().cpu().numpy()

            ell = self.ell
            vals = host(self.values_as(torch.float32))
            if ell is not None:
                return np.asarray(ell.cols), vals, np.asarray(ell.row_map)
            return host(self.cols), vals, host(self.row_map)

        return self.memo("host_f32", build)

    def sharded(self, n_shards: int, block_rows: int,
                reserve_empty_block: bool = False,
                split: str = "nnz") -> "ShardedOperands":
        """:func:`shard_operands` of these operands, built once per split."""
        return self.memo(
            ("sharded", n_shards, block_rows, reserve_empty_block, split),
            lambda: shard_operands(self, n_shards, block_rows,
                                   reserve_empty_block, split))

    def shard(self, n_shards: int, index: int, block_rows: int,
              reserve_empty_block: bool = False,
              split: str = "nnz") -> "SpmmOperands":
        """Shard ``index`` of :meth:`sharded` as operands of its own on this
        device: f32 values (a plan's precision casts or re-quantizes them
        per shard) and, when these operands carry a host ELL, the shard's
        ELL, from which its schedules are planned.  Built once."""
        def build():
            sh = self.sharded(n_shards, block_rows, reserve_empty_block, split)
            rows = slice(index * sh.rows_per_shard,
                         (index + 1) * sh.rows_per_shard)

            def put(a, dtype):
                return torch.as_tensor(a[rows], dtype=dtype,
                                       device=self.device)

            return SpmmOperands(
                cols=put(sh.cols, torch.int32),
                vals=put(sh.vals, torch.float32),
                row_map=put(sh.row_map, torch.int32),
                n_out_rows=self.n_out_rows,
                ell=sh.shard_ells[index] if sh.shard_ells else None,
            )

        return self.memo(
            ("shard", n_shards, index, block_rows, reserve_empty_block, split),
            build)

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


@dataclasses.dataclass(frozen=True)
class ShardedOperands:
    """Shard-major operand layout: shard ``s`` owns rows
    ``[s * rows_per_shard, (s+1) * rows_per_shard)`` of the flat arrays."""

    cols: np.ndarray      # (n_shards * rows_per_shard, tau)
    vals: np.ndarray
    row_map: np.ndarray   # (n_shards * rows_per_shard,)
    n_out_rows: int
    n_shards: int
    rows_per_shard: int
    shard_ells: Tuple[TiledELL, ...]  # per-shard host views ((), if no ell)


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def shard_operands(
    operands: SpmmOperands,
    n_shards: int,
    block_rows: int,
    reserve_empty_block: bool = False,
    split: str = "nnz",
) -> ShardedOperands:
    """Split the sub-row axis into ``n_shards`` contiguous slices, on the
    host, with the values in f32 (:meth:`SpmmOperands.host_f32`).

    ``split="nnz"`` places the boundaries with the cost model's weighted
    splitter, so every shard owns about the same number of nonzeros;
    ``split="uniform"`` is the equal-row-count split.  Every slice is
    padded to the same block-aligned ``rows_per_shard`` (PAD_COL cols,
    zero vals, -1 row_map).  ``reserve_empty_block`` appends one
    all-padding row block per shard, as the reference's sharded
    ``pallas_sparse`` does: the port's ranks each launch their own grid, so
    the block only keeps the host arrays equal to the reference's; its
    k-tile bitmap is empty and the ``cuda_sparse`` kernel never visits it.
    """
    from repro_torch.plan import cost  # deferred: plan imports exec

    if split not in ("nnz", "uniform"):
        raise ValueError(f"unknown split: {split}")
    cols, vals, rmap = operands.host_f32()
    r, tau = cols.shape
    if split == "nnz":
        weights = (cols != PAD_COL).sum(axis=1)
        bounds = cost.balanced_split_points(weights, n_shards)
    else:
        bounds = cost.balanced_split_points(np.zeros(r), n_shards)
    seg_len = int(np.diff(bounds).max()) if n_shards else 0
    per = _round_up(max(seg_len, 1), block_rows)
    if reserve_empty_block:
        per += block_rows
    out_cols = np.full((n_shards * per, tau), PAD_COL, dtype=np.int32)
    out_vals = np.zeros((n_shards * per, tau), dtype=vals.dtype)
    out_rmap = np.full((n_shards * per,), -1, dtype=np.int32)
    shard_ells = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        n = max(hi - lo, 0)
        out_cols[s * per : s * per + n] = cols[lo:hi]
        out_vals[s * per : s * per + n] = vals[lo:hi]
        out_rmap[s * per : s * per + n] = rmap[lo:hi]
        if operands.ell is not None:
            shard_ells.append(
                TiledELL(
                    cols=out_cols[s * per : (s + 1) * per],
                    vals=out_vals[s * per : (s + 1) * per],
                    row_map=out_rmap[s * per : (s + 1) * per],
                    n_dense_rows=operands.ell.n_dense_rows,
                    n_orig_rows=operands.n_out_rows,
                )
            )
    return ShardedOperands(
        cols=out_cols,
        vals=out_vals,
        row_map=out_rmap,
        n_out_rows=operands.n_out_rows,
        n_shards=n_shards,
        rows_per_shard=per,
        shard_ells=tuple(shard_ells),
    )
