"""The one cost model behind every plan decision.

The port of ``repro.plan.cost``: pure functions over graph statistics and
a device model, so every chooser (``plan.autoplan``, the pipeline planner,
the serving ladder and precision picks) ranks its candidates with the same
arithmetic:

* :func:`spmm_cost`        — bytes, SRAM energy (via
  ``sim.hw_config.sram_pj_per_byte``), collective bytes and FLOPs of one
  planned SpMM, per impl / block sizes / shard count;
* :func:`fused_layer_cost` — the same for a fused GCN layer, and
  :func:`combination_seconds` for the unfused layer's ``X W + b``;
* :func:`roofline_seconds` — the compute/memory/collective roofline bound;
* :func:`rank_specs`       — estimated gradient-sync collective bytes of
  candidate partition specs;
* :func:`balanced_split_points` — contiguous split of a weighted row axis.

Impl names are the port's (``reference | cuda | cuda_sparse``,
``exec.plan.IMPL_NAMES``).

Two kernel families, one per device model.  A :class:`DeviceModel` whose
``cuda`` field is ``None`` (:data:`TPU_V5E`, :func:`flexvector_device`)
prices the reference's Pallas grids with the reference's arithmetic,
number for number: a ``cuda`` plan is the masked ``pallas`` grid over
every (row-block, k-tile) pair, a ``cuda_sparse`` plan the block-skipping
one, and a fused layer keeps its output slab resident in VMEM.  A model
with :class:`CudaRates` (:data:`H100`, the port's default) prices what
the port's own kernels move on the card instead (``csrc/flexvector_spmm.cu``):

* aggregation (B1 ``cuda``, B2 ``cuda_sparse``): the ELL stream once per
  L2 column slab, the gather of one 16-byte-rounded dense row per slot
  at a fitted L2 gather rate, the (R, F) f32 sub-row output; B2 adds its
  per-slot bitmap test and never costs less than B1 on the same shape.
  The kernel takes the real width and no f-tile, so ``block_f`` leaves
  the price unchanged, ``block_k`` moves it only by the padding launch it
  forces, and ties keep the static plan;
* the fold, ``segment_accumulate``'s ``index_add_``: the sub-rows read
  and added atomically into the node rows, at a fitted rate;
* the fused layer (B3/B4): the zero fill of the ``(R, block_f)``-padded
  f32 output, each chunk's tile of ``X W + b`` (f32 on the CUDA cores,
  bf16 on the tensor cores), the scatter's read-modify-write of each run
  of a row's slots in a 64-row column group at a fitted rate, the slot
  decode, then the fold; it is viable whenever its fixed shared-memory
  tile fits a CTA;
* the combination at the fitted f32 rate at every precision (``affine``
  widens bf16 and int8 operands and multiplies in full f32);
* a fixed host cost per launch, which the device overlaps: a term costs
  the larger of its device time and its launches' host time, so tiny
  host-bound shapes are not priced in microseconds.  The launches are the
  torch ops the dispatch runs for the step, counted as it runs them;
* on a data mesh of ``n_shards`` ranks, one rank's share: the work above
  times ``shard_imbalance / n_shards`` (the heaviest shard sets the
  time), then the epilogue's collective (and a row-sharded dense
  operand's all-gather) at the reference's per-device ring bytes over
  ``ici_bw``, after the kernels (the port does not overlap them), and one
  launch per collective.

Everything here is numpy + dataclasses over host statistics; the H100
terms borrow the kernel wrappers' own width, slab and chunk rules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sparse_formats import PAD_COL, TiledELL
from repro_torch.kernels import flexvector_spmm as fv
from repro_torch.sim.hw_config import HWConfig, PJ_PER_BYTE_DRAM, sram_pj_per_byte


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, q: int) -> int:
    return _ceil_div(max(x, 0), q) * q


# Storage widths of the ``exec.quant`` precisions: the stored value width
# and the activation (dense operand / writeback) width — int8 keeps
# activations in bf16, hence the asymmetry.
_PRECISION_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
_PRECISION_ACT_BYTES = {"f32": 4, "bf16": 2, "int8": 2}


# ---------------------------------------------------------------------------
# Device model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CudaRates:
    """What the port's CUDA kernels achieve on one card, fitted to its own
    kernel and forward times (``scripts/fit_device_model.py``).

    ``gather_bw`` — bytes/s of the aggregation's dense-row gathers (one
    16-byte-rounded row per slot), served mostly from L2;
    ``bitmap_s`` — seconds per slot visit of the sparse grids' k-tile
    bitmap test;
    ``fold_bw`` — sub-row bytes/s of ``index_add_``'s atomic fold;
    ``scatter_bw`` — bytes/s of the fused scatter's read-modify-writes
    (two passes over the 32-byte sectors of a run's real columns);
    ``gemm_flops`` — f32 FLOP/s of the combination ``X W + b``;
    ``tile_flops_f32`` / ``tile_flops_bf16`` — FLOP/s of the fused
    kernels' tile product, f32 on the CUDA cores and bf16 on the tensor
    cores;
    ``launch_s`` — host seconds per launch (dispatch and enqueue).
    """

    gather_bw: float
    bitmap_s: float
    fold_bw: float
    scatter_bw: float
    gemm_flops: float
    tile_flops_f32: float
    tile_flops_bf16: float
    launch_s: float


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Per-chip peaks + energy constants the cost terms are normalized by.

    ``step_overhead_s`` charges each visited kernel grid step a fixed
    launch/setup cost (the ASIC's per-tile ``c_setup`` analogue); it is
    what keeps the block-size argmin away from degenerate tiny tiles.
    ``cuda`` selects the kernel family the terms price: ``None`` for the
    reference's Pallas grids, :class:`CudaRates` for the port's kernels.
    """

    name: str = "tpu-v5e"
    peak_flops: float = 197e12           # bf16 FLOP/s per chip
    hbm_bw: float = 819e9                # bytes/s per chip
    ici_bw: float = 50e9                 # bytes/s per link
    hbm_capacity_bytes: float = 16e9
    vmem_bytes: float = 16e6             # on-chip vector memory per core
    dram_pj_per_byte: float = PJ_PER_BYTE_DRAM
    dense_buffer_bytes: int = 2048       # SRAM-energy anchor (HWConfig)
    sparse_buffer_bytes: int = 256
    step_overhead_s: float = 2e-9
    cuda: Optional[CudaRates] = None

    def bytes_per_element(self, dtype) -> int:
        """Stored bytes per element: ``exec.quant`` precision names
        (``"f32"``/``"bf16"``/``"int8"``), torch dtypes and anything
        ``np.dtype`` understands."""
        if isinstance(dtype, str) and dtype in _PRECISION_BYTES:
            return _PRECISION_BYTES[dtype]
        if isinstance(dtype, torch.dtype):
            return torch.empty(0, dtype=dtype).element_size()
        return int(np.dtype(dtype).itemsize)


TPU_V5E = DeviceModel()

#: One NVIDIA H100 SXM (80 GB HBM3) running the port's kernels: the
#: published peaks (HBM3 3.35 TB/s, 989 TFLOP/s dense bf16 on the tensor
#: cores) and the kernels' rates fitted on the card by
#: ``scripts/fit_device_model.py`` at PubMed and Reddit (``PERF.md``
#: records the run, the card and its power limit).  ``ici_bw`` is NVLink
#: 4's published 450 GB/s a direction, not fitted: one card cannot
#: measure a link between two.
H100 = DeviceModel(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_capacity_bytes=80e9,
    vmem_bytes=227 * 1024,               # shared memory one CTA may hold
    step_overhead_s=0.0,
    # fitted on an NVIDIA H100 80GB HBM3 at a 700 W power limit
    cuda=CudaRates(
        gather_bw=5.499e12,
        bitmap_s=7.710e-12,
        fold_bw=5.073e11,
        scatter_bw=2.711e12,
        gemm_flops=3.789e13,
        tile_flops_f32=3.440e13,
        tile_flops_bf16=1.244e14,
        launch_s=4.551e-5,
    ),
)

def model_or_default(device: Optional[DeviceModel]) -> DeviceModel:
    """``device``, or :data:`H100`, the port's default model, for None.
    The entry points that plan take it as ``device_model=``."""
    return H100 if device is None else device


def flexvector_device(hw: Optional[HWConfig] = None) -> DeviceModel:
    """Device model of the paper's FlexVector tile (Section VI-A3)."""
    hw = hw or HWConfig()
    return DeviceModel(
        name="flexvector",
        peak_flops=2.0 * hw.lanes * hw.freq_hz,
        hbm_bw=hw.dram_bw_bytes_per_s,
        ici_bw=hw.dram_bw_bytes_per_s,   # single tile: no ICI, DRAM-bound
        hbm_capacity_bytes=1e12,
        dram_pj_per_byte=hw.dram_pj_per_bit * 8,
        dense_buffer_bytes=hw.dense_buffer_bytes,
        sparse_buffer_bytes=hw.sparse_buffer_bytes,
        step_overhead_s=hw.c_setup / hw.freq_hz,
    )


# ---------------------------------------------------------------------------
# Graph statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """The sparse-operand statistics every cost term is a function of."""

    padded_rows: int            # ELL rows incl. block padding
    n_sub_rows: int             # real (row_map >= 0) vertex-cut sub-rows
    n_out_rows: int             # original output rows
    n_dense_rows: int           # K dimension
    nnz: int
    tau: int
    row_nnz: Optional[np.ndarray] = None   # (padded_rows,) valid counts
    ell: Optional[TiledELL] = None         # exact block occupancy, if host
    # memo of the O(nnz) scans, which depend only on block sizes while the
    # planners price many candidates per block pair
    _occ_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def rows_per_node(self) -> int:
        """Vertex-cut expansion factor: padded sub-rows per output row —
        the serving bucket ladder's ELL-row budget per node."""
        return _ceil_div(self.padded_rows, max(self.n_out_rows, 1))

    @property
    def mean_row_nnz(self) -> float:
        return self.nnz / max(self.n_sub_rows, 1)

    def _memo(self, key, build):
        hit = self._occ_cache.get(key)
        if hit is None:
            hit = self._occ_cache[key] = build()
        return hit

    def occupied_pairs(self, block_rows: int, block_k: int) -> int:
        """Non-empty (row-block, k-tile) cells of the launch grid.

        Exact via ``TiledELL.block_occupancy`` when the host container is
        available; otherwise the spread upper bound min(grid, nnz).
        """
        def build():
            n_rb = _ceil_div(self.padded_rows, block_rows)
            n_kb = _ceil_div(self.n_dense_rows, block_k)
            if self.ell is not None:
                return int(self.ell.block_occupancy(block_rows, block_k).sum())
            return int(min(n_rb * n_kb, max(self.nnz, n_rb)))

        return self._memo((block_rows, block_k), build)

    def occupied_k_tiles(self, block_k: int) -> int:
        """k-tiles holding at least one nonzero *anywhere* in the matrix —
        the number of steps the fused sparse-grid launch streams an
        ``X`` tile for.

        Exact via the host container when available; otherwise the
        spread upper bound min(n_kb, nnz) (every nonzero in its own
        tile).
        """
        def build():
            n_kb = _ceil_div(self.n_dense_rows, block_k)
            if self.ell is not None:
                tiles = int(
                    self.ell.block_occupancy(self.padded_rows, block_k)
                    .any(axis=0).sum()
                )
            else:
                tiles = int(min(n_kb, max(self.nnz, 1)))
            return max(tiles, 1)

        return self._memo(("ktiles", block_k), build)

    def scatter_runs(self) -> int:
        """Runs of the fused scatter: (row, 64-row column group) pairs
        holding a slot.  The slot lists order a group's slots by flat
        index, so a row's slots in one group are consecutive and take one
        read-modify-write of its output row.  Exact from the host
        container; otherwise the upper bound nnz (each slot a run)."""
        def build():
            if self.ell is None:
                return int(self.nnz)
            g = np.where(self.ell.cols != PAD_COL,
                         self.ell.cols // fv.XW_TILE_ROWS, -1)
            g = np.sort(g, axis=1)
            new = g[:, 1:] != g[:, :-1]
            return int((g[:, :1] >= 0).sum() + ((g[:, 1:] >= 0) & new).sum())

        return self._memo("scatter_runs", build)

    def column_chunks(self) -> int:
        """CTAs of one fused launch per 128 output columns: the chunks
        ``kernels.flexvector_spmm.column_slots`` cuts.  Exact from the
        host container; otherwise its bound ``max_column_chunks``."""
        def build():
            if self.ell is None:
                return fv.max_column_chunks(self.n_dense_rows, self.nnz)
            c = self.ell.cols[self.ell.cols != PAD_COL]
            counts = np.bincount(c // fv.XW_TILE_ROWS)
            return int((-(-counts // fv.chunk_slots(counts))).sum())

        return self._memo("column_chunks", build)


def graph_stats_from_ell(ell: TiledELL) -> GraphStats:
    """Exact stats of a preprocessed bounded-row operand."""
    valid = ell.cols != PAD_COL
    return GraphStats(
        padded_rows=ell.padded_rows,
        n_sub_rows=int((ell.row_map >= 0).sum()),
        n_out_rows=ell.n_orig_rows,
        n_dense_rows=ell.n_dense_rows,
        nnz=int(valid.sum()),
        tau=ell.tau,
        row_nnz=valid.sum(axis=1).astype(np.int64),
        ell=ell,
    )


def synthetic_stats(
    rows: int,
    n_out_rows: int,
    n_dense_rows: int,
    nnz: int,
    tau: int,
) -> GraphStats:
    """Stats for a shape that exists only as a plan (e.g. a serving bucket
    rung before any request has landed in it)."""
    return GraphStats(
        padded_rows=rows,
        n_sub_rows=rows,
        n_out_rows=n_out_rows,
        n_dense_rows=n_dense_rows,
        nnz=int(min(nnz, rows * tau)),
        tau=tau,
    )


# ---------------------------------------------------------------------------
# SpMM cost terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Traffic / energy / time estimate of one planned SpMM.

    ``host_s`` is the host time of the term's launches (0 under the
    Pallas model); the device runs behind it, so the term takes the
    larger of the two.
    """

    flops: float                 # total useful+padded MACs x2
    dram_bytes: float            # total DRAM traffic, all shards
    collective_bytes: float      # per-device cross-shard bytes
    sram_pj: float               # on-chip buffer energy
    dram_pj: float
    compute_s: float             # per-device roofline terms
    memory_s: float
    collective_s: float
    dominant: str
    host_s: float = 0.0

    @property
    def seconds(self) -> float:
        """The roofline bound — the scalar every argmin minimizes."""
        return max(self.compute_s, self.memory_s, self.collective_s,
                   self.host_s)

    @property
    def energy_pj(self) -> float:
        return self.sram_pj + self.dram_pj


def roofline_seconds(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    device: Optional[DeviceModel] = None,
) -> Tuple[float, float, float, str]:
    """compute/memory/collective roofline terms + the dominant one."""
    device = model_or_default(device)
    compute = flops_per_device / device.peak_flops
    memory = bytes_per_device / device.hbm_bw
    collective = coll_bytes_per_device / device.ici_bw
    terms = {"compute": compute, "memory": memory, "collective": collective}
    return compute, memory, collective, max(terms, key=terms.get)


def psum_bytes(n_out_rows: int, feature_dim: int, n_shards: int,
               dtype_bytes: int = 4) -> float:
    """Per-device bytes of the full-height cross-shard segment-psum that
    folds vertex-cut partials (ring all-reduce: 2(n-1)/n of the buffer)."""
    if n_shards <= 1:
        return 0.0
    buf = float(n_out_rows) * feature_dim * dtype_bytes
    return 2.0 * buf * (n_shards - 1) / n_shards


def reduce_scatter_bytes(n_out_rows: int, feature_dim: int, n_shards: int,
                         dtype_bytes: int = 4) -> float:
    """Per-device bytes of the row-sharded epilogue: ring reduce-scatter
    moves (n-1)/n of the buffer — half the all-reduce — over the *padded*
    output height (``round_up`` to the axis width)."""
    if n_shards <= 1:
        return 0.0
    buf = float(_round_up(n_out_rows, n_shards)) * feature_dim * dtype_bytes
    return buf * (n_shards - 1) / n_shards


def all_gather_bytes(n_rows: int, feature_dim: int, n_shards: int,
                     dtype_bytes: int = 4) -> float:
    """Per-device bytes to all-gather a row-sharded dense operand inside
    the shard body (ring all-gather: (n-1)/n of the full buffer)."""
    if n_shards <= 1:
        return 0.0
    buf = float(_round_up(n_rows, n_shards)) * feature_dim * dtype_bytes
    return buf * (n_shards - 1) / n_shards


def activation_writeback_bytes(
    n_out_rows: int,
    feature_dim: int,
    n_shards: int,
    layout: str = "replicated",
    dtype_bytes: int = 4,
) -> float:
    """Total DRAM bytes the mesh writes to materialize one layer's output
    activation under ``layout``: a replicated activation is written by
    *every* device (n x the full height), a row-sharded one is written
    once across the mesh (the padded height)."""
    n = max(n_shards, 1)
    if layout == "row_sharded" and n > 1:
        return float(_round_up(n_out_rows, n)) * feature_dim * dtype_bytes
    return float(n) * n_out_rows * feature_dim * dtype_bytes


def _storage_bytes(precision: str, dtype_bytes: int):
    """(ELL value bytes, activation bytes) at ``precision``."""
    if precision == "f32":
        return dtype_bytes, dtype_bytes
    return _PRECISION_BYTES[precision], _PRECISION_ACT_BYTES[precision]


def _epilogue_bytes(stats, f, f_gather, n_shards, out_layout, dense_layout,
                    dtype_bytes, act_bytes) -> float:
    """Per-device collective bytes of the layer's epilogue (psum or
    reduce-scatter) and, for a row-sharded dense operand, its all-gather
    at ``f_gather`` columns."""
    if out_layout == "row_sharded":
        coll = reduce_scatter_bytes(stats.n_out_rows, f, n_shards, dtype_bytes)
    else:
        coll = psum_bytes(stats.n_out_rows, f, n_shards, dtype_bytes)
    if dense_layout == "row_sharded":
        coll += all_gather_bytes(stats.n_dense_rows, f_gather, n_shards,
                                 act_bytes)
    return coll


# -- the port's CUDA kernels ------------------------------------------------
#
# Each step's *work* (bytes by the rate that moves them, slot visits,
# FLOPs, host launches) is counted from the shapes; :func:`cuda_seconds`
# turns work into time at a device's rates.  ``scripts/fit_device_model.py``
# fits the rates from the card's times over the same counts.

#: Host launches: the torch ops of one dispatch that reach the device,
#: counted op for op as ``exec.dispatch.execute_layer`` runs them (views
#: and bare allocations launch nothing; ``tests/test_torch_plan.py``
#: counts the ops it really runs against these).  The fold
#: (``segment_accumulate``): the mask, ``where``, the index cast, ``zeros``
#: and ``index_add_``.
_FOLD_LAUNCHES = 5
#: ``quant.affine``: the matmul and the bias add; under bf16 ``x`` rounded
#: to bf16 and back and the (bf16-stored) ``w`` widened; under int8 ``w``
#: dequantized (three ops) and rounded to bf16 first.
_AFFINE_LAUNCHES = {"f32": 2, "bf16": 5, "int8": 9}
#: ``exec.fused.fused_args``' casts: ``x`` to bf16; under int8 ``w``
#: dequantized and cast too.
_FUSED_CAST_LAUNCHES = {"f32": 0, "bf16": 1, "int8": 5}


def _copy_launches(padded: bool) -> int:
    """``fv._zero_padded``: a zeroed buffer and the copy into it."""
    return 2 if padded else 0


def _act_dtype(precision: str) -> torch.dtype:
    return torch.float32 if precision == "f32" else torch.bfloat16


def _fold_work(stats: GraphStats, r_pad: int, f: int, row_cols: int) -> dict:
    """``segment_accumulate``: the (R, F) f32 sub-rows (rows ``row_cols``
    wide in memory) read and added atomically into a zeroed (n_out_rows,
    F) output."""
    return {"fold": float(r_pad) * row_cols * 4,
            "hbm": float(stats.n_out_rows) * f * 4,
            "launches": _FOLD_LAUNCHES}


def _add_work(*works: dict) -> dict:
    out: dict = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0) + v
    return out


def _sharded_work(work: dict, n_shards: int, shard_imbalance: float,
                  collective_bytes: float, collectives: int) -> dict:
    """One rank's share of ``work`` on a data mesh: every byte, FLOP and
    slot visit times ``imbalance / n_shards``, the launches as they are,
    plus the collectives' per-device bytes and one launch each."""
    if n_shards <= 1:
        return work
    scale = max(float(shard_imbalance), 1.0) / n_shards
    out = {k: (v if k == "launches" else v * scale) for k, v in work.items()}
    out["collective"] = collective_bytes
    out["launches"] += collectives
    return out


def cuda_spmm_work(stats: GraphStats, feature_dim: int, *, impl: str = "cuda",
                   block_rows: int = 128, block_k: int = 128,
                   precision: str = "f32", dtype_bytes: int = 4,
                   idx_bytes: int = 4, n_shards: int = 1,
                   dense_rows: Optional[int] = None) -> dict:
    """Work of one aggregation and its fold on the port's kernels.

    ``cuda``/``cuda_sparse`` (B1/B2): the dense operand cast to bf16 under
    bf16/int8, the ELL table streamed once per L2 column slab (with the
    int8 scales), the dense operand read into L2 once, the (R, F) f32
    sub-row output at the real width rounded to 16 bytes (``hbm``); one
    16-byte-rounded dense row gathered per slot (``gather``); under
    ``cuda_sparse`` a bitmap test per slot and slab (``bitmap``).
    ``reference``: the plain gather, a gathered (R, F) temporary per ELL
    column with its product and running sum.  Then the fold.

    The launches are one dispatch's, on one device or, with ``n_shards >
    1``, on one shard (whose rows are whole blocks, so it pads none) of a
    ``dense_rows``-row dense operand (default the graph's K; a
    row-sharded operand arrives at the height padded to the mesh).
    """
    f = max(feature_dim, 1)
    val_bytes, act_bytes = _storage_bytes(precision, dtype_bytes)
    r_pad = _round_up(stats.padded_rows, block_rows)
    k = max(stats.n_dense_rows, 1)
    k_in = k if dense_rows is None else dense_rows
    row_pads = 2 * (r_pad != stats.padded_rows and n_shards <= 1)
    scales = _ceil_div(r_pad, block_rows) * 4.0 if precision == "int8" else 0.0
    cast = float(k) * f * (4 + act_bytes) if precision != "f32" else 0.0
    ell = float(r_pad) * stats.tau * (idx_bytes + val_bytes)
    if impl == "reference":
        # the masks and zeros, then per ELL column a gather (widened from
        # bf16), a product and a running sum; bf16 values widened, int8
        # ones dequantized, per call
        work = {"hbm": cast + ell + scales + 5.0 * stats.tau * r_pad * f * 4,
                "launches": (6 + stats.tau * (3 if precision == "f32" else 4)
                             + {"f32": 0, "bf16": 1, "int8": 3}[precision])}
        row_cols = f
    elif impl in ("cuda", "cuda_sparse"):
        act = _act_dtype(precision)
        row_cols = fv.aligned_width(f, act)
        n_slabs = _ceil_div(row_cols, fv.slab_width(k, row_cols, act))
        work = {"hbm": (cast + ell * n_slabs + scales
                        + float(k) * row_cols * act_bytes
                        + float(r_pad) * row_cols * 4),
                "gather": float(stats.nnz) * row_cols * act_bytes,
                # fv.pad_operands: the table's rows (cols and vals) and
                # the dense operand, where not whole blocks; the kernel
                "launches": (row_pads
                             + (k_in % block_k != 0 or row_cols != f) + 1)}
        if impl == "cuda_sparse":
            work["bitmap"] = float(stats.nnz) * n_slabs
    else:
        raise ValueError(f"unknown impl for cost model: {impl}")
    if precision != "f32":
        work["launches"] += 1             # quant.cast_dense
    return _add_work(work, _fold_work(stats, r_pad, f, row_cols))


def cuda_fused_work(stats: GraphStats, f_in: int, f_out: int, *,
                    impl: str = "cuda", block_rows: int = 128,
                    block_k: int = 128, block_f: int = 128,
                    precision: str = "f32",
                    dtype_bytes: int = 4, idx_bytes: int = 4,
                    n_shards: int = 1,
                    dense_rows: Optional[int] = None) -> dict:
    """Work of one fused layer on the port's kernel (B3/B4), then its fold.

    ``hbm``: the zero fill of the ``(R, block_f)``-padded f32 output, the
    casts of ``x`` under bf16/int8, the weights, the slot decode (each
    slot's id and a 32-byte sector each of its column and value) and the
    int8 scales; ``scatter``: one read-modify-write of the 32-byte sectors
    of the row's real columns per run (``GraphStats.scatter_runs``);
    ``tile_flops``: each chunk's (64, 128) tile of ``X W + b`` over the
    16-byte-rounded input width (``GraphStats.column_chunks`` per 128
    output columns); under ``cuda_sparse`` a bitmap test per slot.  The
    launches as :func:`cuda_spmm_work` counts them (``dense_rows`` is the
    height of ``X``).
    """
    f = max(f_out, 1)
    val_bytes, act_bytes = _storage_bytes(precision, dtype_bytes)
    r_pad = _round_up(stats.padded_rows, block_rows)
    k = max(stats.n_dense_rows, 1)
    k_in = k if dense_rows is None else dense_rows
    f_pad = _round_up(f, block_f)
    act = _act_dtype(precision)
    f_in_a = fv.aligned_width(f_in, act)
    hbm = (float(r_pad) * f_pad * 4
           + float(f_in) * f_pad * val_bytes
           + float(stats.nnz) * (idx_bytes + 2 * 32))
    if precision != "f32":
        hbm += float(k) * f_in * (4 + act_bytes)
    if precision == "int8":
        hbm += _ceil_div(r_pad, block_rows) * 4.0
    ctas = stats.column_chunks() * _ceil_div(f_pad, fv.XW_TILE_COLS)
    work = {
        "hbm": hbm,
        "scatter": 2.0 * stats.scatter_runs() * 32 * _ceil_div(4 * f, 32),
        "tile_flops": 2.0 * ctas * fv.XW_TILE_ROWS * f_in_a * fv.XW_TILE_COLS,
        # the casts; the table's rows, x, w and b padded where not whole
        # blocks or 16-byte rows (fused_args, fv.pad_fused_operands, the
        # wrapper's w stride); the zeroed output and the kernel
        "launches": (_FUSED_CAST_LAUNCHES[precision]
                     + 2 * (r_pad != stats.padded_rows and n_shards <= 1)
                     + _copy_launches(k_in % block_k != 0 or f_in_a != f_in)
                     + _copy_launches(f_in_a != f_in or f_pad != f)
                     + (f_pad != f)
                     + _copy_launches(fv.aligned_width(f_pad, act) != f_pad)
                     + 2),
    }
    if impl == "cuda_sparse":
        work["bitmap"] = float(stats.nnz)
    return _add_work(work, _fold_work(stats, r_pad, f, f))


def cuda_combination_work(k_rows: int, f_in: int, f_out: int,
                          precision: str = "f32") -> dict:
    """Work of ``exec.quant.affine`` on the card: the f32 matmul's
    ``flops`` and its ``matmul`` bytes (``X``, ``W``, ``X W``), and in
    further passes (``hbm``) the bias add and, under bf16/int8, the
    rounding of ``X`` to bf16 and back."""
    work = {"flops": 2.0 * k_rows * f_in * f_out,
            "matmul": float(k_rows) * (f_in + f_out) * 4 + float(f_in) * f_out * 4,
            "hbm": 2.0 * k_rows * f_out * 4,
            "launches": _AFFINE_LAUNCHES[precision]}
    if precision != "f32":
        work["hbm"] += float(k_rows) * f_in * 2 * (4 + 2)
    return work


def cuda_seconds(work: dict, precision: str, device: DeviceModel) -> Tuple[float, float]:
    """``(device seconds, host seconds)`` of one step's work at ``device``'s
    rates: each kind of traffic at its own rate, one after the other (the
    steps are separate launches or phases of one); the matmul at the
    larger of its FLOP and byte time; the collectives' bytes at
    ``ici_bw``; the launches at ``launch_s`` each."""
    r = device.cuda
    tile_rate = r.tile_flops_f32 if precision == "f32" else r.tile_flops_bf16
    t = (work.get("collective", 0.0) / device.ici_bw
         + work.get("hbm", 0.0) / device.hbm_bw
         + work.get("gather", 0.0) / r.gather_bw
         + work.get("bitmap", 0.0) * r.bitmap_s
         + work.get("fold", 0.0) / r.fold_bw
         + work.get("scatter", 0.0) / r.scatter_bw
         + work.get("tile_flops", 0.0) / tile_rate)
    if "flops" in work:
        t += max(work["flops"] / r.gemm_flops, work["matmul"] / device.hbm_bw)
    return t, work.get("launches", 0) * r.launch_s


def _cuda_cost(work: dict, flops: float, precision: str,
               device: DeviceModel) -> CostBreakdown:
    device_s, host_s = cuda_seconds(work, precision, device)
    dram = (work.get("hbm", 0.0) + work.get("scatter", 0.0)
            + work.get("fold", 0.0))
    coll = work.get("collective", 0.0)
    return CostBreakdown(
        flops=flops,
        dram_bytes=dram,
        collective_bytes=coll,
        sram_pj=0.0,
        dram_pj=dram * device.dram_pj_per_byte,
        compute_s=0.0,
        memory_s=device_s,
        collective_s=coll / device.ici_bw,
        dominant="memory" if device_s >= host_s else "host",
        host_s=host_s,
    )


def _sharded_dense_rows(stats: GraphStats, n_shards: int,
                        dense_layout: str) -> int:
    """Height of the dense operand a shard aggregates: a row-sharded one
    is gathered at the height padded to the mesh."""
    if n_shards > 1 and dense_layout == "row_sharded":
        return _round_up(stats.n_dense_rows, n_shards)
    return stats.n_dense_rows


def _collectives(n_shards: int, dense_layout: str) -> int:
    """Collective launches of one sharded dispatch: the epilogue's, and
    the all-gather of a row-sharded dense operand."""
    if n_shards <= 1:
        return 0
    return 1 + (dense_layout == "row_sharded")


def spmm_cost(
    stats: GraphStats,
    feature_dim: int,
    *,
    impl: str = "reference",
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    n_shards: int = 1,
    out_layout: str = "replicated",
    dense_layout: str = "replicated",
    shard_imbalance: float = 1.0,
    dtype_bytes: int = 4,
    idx_bytes: int = 4,
    precision: str = "f32",
    device: Optional[DeviceModel] = None,
) -> CostBreakdown:
    """Traffic/energy/time estimate of ``A @ D`` under one plan.

    Under the Pallas model (D is ``(K, F)``):

    * ``reference`` — XLA gather: one dense row read per nonzero (no tile
      reuse), no padding inflation;
    * ``cuda`` — the masked dense grid: every (row-block, k-tile) pair is
      visited, so compute and sparse-operand reads scale with the *padded*
      grid and each row block re-streams its tau slots per k-tile;
    * ``cuda_sparse`` — the block-skipping grid: only occupied pairs are
      visited (exact occupancy when the host ``TiledELL`` is available).

    Sharding divides compute/DRAM terms across ``n_shards`` and adds the
    epilogue collective term (the psum, or the reduce-scatter under
    ``out_layout="row_sharded"``; ``dense_layout="row_sharded"`` adds the
    all-gather of the dense operand); ``shard_imbalance`` scales the
    per-device terms.  ``precision`` sizes every traffic term with the
    ``exec.quant`` storage widths; the reduction collectives move f32
    partials (``dtype_bytes``).

    Under the CUDA kernel model it prices the port's aggregation and fold
    (module docstring), and on a data mesh one rank's share and the
    collectives.
    """
    device = model_or_default(device)
    f = max(feature_dim, 1)
    if device.cuda is not None:
        _, act_bytes = _storage_bytes(precision, dtype_bytes)
        work = cuda_spmm_work(
            stats, f, impl=impl, block_rows=block_rows, block_k=block_k,
            precision=precision, dtype_bytes=dtype_bytes,
            idx_bytes=idx_bytes, n_shards=n_shards,
            dense_rows=_sharded_dense_rows(stats, n_shards, dense_layout))
        work = _sharded_work(
            work, n_shards, shard_imbalance,
            _epilogue_bytes(stats, f, f, n_shards, out_layout, dense_layout,
                            dtype_bytes, act_bytes),
            _collectives(n_shards, dense_layout))
        return _cuda_cost(work, 2.0 * stats.nnz * f, precision, device)
    r_pad = _round_up(stats.padded_rows, block_rows)
    k_pad = _round_up(stats.n_dense_rows, block_k)
    f_pad = _round_up(f, block_f)
    n_rb = _ceil_div(r_pad, block_rows)
    n_kb = _ceil_div(k_pad, block_k)
    n_fb = _ceil_div(f_pad, block_f)
    val_bytes, act_bytes = _storage_bytes(precision, dtype_bytes)
    ell_entry_bytes = idx_bytes + val_bytes
    scale_bytes = n_rb * 4.0 if precision == "int8" else 0.0

    if impl == "reference":
        flops = 2.0 * stats.nnz * f
        dense_bytes = float(stats.nnz) * f * act_bytes   # gather, no reuse
        sparse_bytes = float(stats.nnz) * ell_entry_bytes + scale_bytes
        grid_steps = 0
    else:
        if impl == "cuda":
            visited = n_rb * n_kb
        elif impl == "cuda_sparse":
            visited = stats.occupied_pairs(block_rows, block_k)
        else:
            raise ValueError(f"unknown impl for cost model: {impl}")
        # each visited pair processes block_rows x tau slots per f-tile
        flops = 2.0 * visited * block_rows * stats.tau * f_pad
        dense_bytes = float(visited) * block_k * f_pad * act_bytes
        sparse_bytes = (
            float(visited) * n_fb * block_rows * stats.tau * ell_entry_bytes
            + scale_bytes
        )
        grid_steps = visited * n_fb

    out_bytes = float(r_pad + stats.n_out_rows) * f * act_bytes
    dram_bytes = dense_bytes + sparse_bytes + out_bytes
    coll_bytes = _epilogue_bytes(stats, f, f, n_shards, out_layout,
                                 dense_layout, dtype_bytes, act_bytes)

    shards = max(n_shards, 1)
    imb = max(float(shard_imbalance), 1.0)
    compute, memory, collective, dominant = roofline_seconds(
        flops / shards * imb, dram_bytes / shards * imb, coll_bytes, device
    )
    compute += (grid_steps / shards) * imb * device.step_overhead_s
    if compute > max(memory, collective):
        dominant = "compute"
    return CostBreakdown(
        flops=flops,
        dram_bytes=dram_bytes,
        collective_bytes=coll_bytes,
        sram_pj=(dense_bytes + out_bytes)
        * sram_pj_per_byte(device.dense_buffer_bytes)
        + sparse_bytes * sram_pj_per_byte(device.sparse_buffer_bytes),
        dram_pj=dram_bytes * device.dram_pj_per_byte,
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        dominant=dominant,
    )


def combination_seconds(
    k_rows: int,
    f_in: int,
    f_out: int,
    *,
    n_shards: int = 1,
    precision: str = "f32",
    device: Optional[DeviceModel] = None,
) -> float:
    """Seconds of the standalone dense combination ``X @ W + b`` — one
    read of ``X`` and ``W``, one write of the intermediate ``XW``
    activation (its read-back is charged to the aggregation's
    dense-operand term in :func:`spmm_cost`).

    Under the Pallas model, the roofline at the storage widths, divided
    across ``n_shards`` row shards.  Under the CUDA kernel model, what
    ``exec.quant.affine`` runs: bf16/int8 operands rounded and widened
    back to f32 (two passes over ``X``), a full-f32 matmul at the fitted
    rate, the bias added in a second pass, on one rank's ``k_rows /
    n_shards`` rows; the larger of that device time and its launches'
    host time.
    """
    device = model_or_default(device)
    act_b = _PRECISION_ACT_BYTES.get(precision, 4)
    val_b = _PRECISION_BYTES.get(precision, 4)
    flops = 2.0 * k_rows * f_in * f_out
    if device.cuda is not None:
        rows = _ceil_div(k_rows, max(n_shards, 1))
        return max(cuda_seconds(
            cuda_combination_work(rows, f_in, f_out, precision), precision,
            device))
    dram = (
        float(k_rows) * f_in * act_b
        + float(f_in) * f_out * val_b
        + float(k_rows) * f_out * act_b
    )
    shards = max(n_shards, 1)
    compute, memory, _, _ = roofline_seconds(
        flops / shards, dram / shards, 0.0, device
    )
    return max(compute, memory)


def fused_vmem_bytes(
    padded_rows: int,
    tau: int,
    f_in: int,
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    precision: str = "f32",
    n_shards: int = 1,
) -> float:
    """VMEM footprint of one grid step of the reference's fused launch
    (per shard): the *entire* per-shard output column slab resident —
    ``(r_pad / n_shards, block_f)`` f32 — plus the full ELL table, the
    weight slab, the streamed ``X`` tile (double-buffered) and the
    ``XW``/expansion scratch.  The Pallas model gates fused candidates on
    it; the port's fused kernel has no such slab (:func:`fused_viable`).
    """
    act_b = _PRECISION_ACT_BYTES.get(precision, 4)
    val_b = _PRECISION_BYTES.get(precision, 4)
    r_pad = _round_up(
        _ceil_div(padded_rows, max(n_shards, 1)), block_rows
    )
    n_rb = _ceil_div(r_pad, block_rows)
    out_slab = float(r_pad) * block_f * 4
    ell_table = float(r_pad) * tau * (4 + val_b)
    scales = n_rb * 4.0 if precision == "int8" else 0.0
    x_tile = 2.0 * block_k * f_in * act_b          # double-buffered stream
    w_slab = float(f_in) * block_f * (4 if precision == "f32" else 2)
    xw_scratch = float(block_k) * block_f * 4
    expand = float(block_rows) * (block_k + block_f) * 4
    return out_slab + ell_table + scales + x_tile + w_slab + xw_scratch + expand


def fused_layer_cost(
    stats: GraphStats,
    f_in: int,
    f_out: int,
    *,
    impl: str = "cuda",
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    n_shards: int = 1,
    out_layout: str = "replicated",
    dense_layout: str = "replicated",
    shard_imbalance: float = 1.0,
    dtype_bytes: int = 4,
    idx_bytes: int = 4,
    precision: str = "f32",
    device: Optional[DeviceModel] = None,
) -> CostBreakdown:
    """Traffic/energy/time estimate of one *fused* GCN layer:
    ``A @ (X @ W + b)`` in a single launch.

    Covers the whole layer, so compare against
    ``spmm_cost(...).seconds + combination_seconds(...)``.  Under the
    Pallas model: the intermediate ``(K, F_out)`` activation is never
    written or read back, the ELL table streams once (VMEM-resident), and
    ``X`` streams once per f-tile over the *occupied* k-tiles with the
    combination FLOPs recomputed per f-tile.  Under the CUDA kernel model:
    the port's fused kernel (module docstring), and on a data mesh one
    rank's share and the collectives (a row-sharded ``X`` gathered at
    ``F_in`` width).
    """
    device = model_or_default(device)
    f = max(f_out, 1)
    if device.cuda is not None:
        _, act_bytes = _storage_bytes(precision, dtype_bytes)
        work = cuda_fused_work(
            stats, f_in, f, impl=impl, block_rows=block_rows,
            block_k=block_k, block_f=block_f, precision=precision,
            dtype_bytes=dtype_bytes, idx_bytes=idx_bytes, n_shards=n_shards,
            dense_rows=_sharded_dense_rows(stats, n_shards, dense_layout))
        flops = work["tile_flops"]
        work = _sharded_work(
            work, n_shards, shard_imbalance,
            _epilogue_bytes(stats, f, f_in, n_shards, out_layout,
                            dense_layout, dtype_bytes, act_bytes),
            _collectives(n_shards, dense_layout))
        return _cuda_cost(work, flops, precision, device)
    r_pad = _round_up(stats.padded_rows, block_rows)
    k_pad = _round_up(stats.n_dense_rows, block_k)
    f_pad = _round_up(f, block_f)
    n_rb = _ceil_div(r_pad, block_rows)
    n_kb = _ceil_div(k_pad, block_k)
    n_fb = _ceil_div(f_pad, block_f)
    val_bytes, act_bytes = _storage_bytes(precision, dtype_bytes)
    if impl == "cuda_sparse":
        occ_kb = min(stats.occupied_k_tiles(block_k), n_kb)
    else:
        occ_kb = n_kb

    sparse_bytes = float(r_pad) * stats.tau * (idx_bytes + val_bytes)
    if precision == "int8":
        sparse_bytes += n_rb * 4.0
    x_bytes = float(n_fb) * occ_kb * block_k * f_in * act_bytes
    w_bytes = float(f_in) * f_pad * val_bytes
    out_bytes = float(r_pad + stats.n_out_rows) * f * act_bytes
    dram_bytes = sparse_bytes + x_bytes + w_bytes + out_bytes

    # Combination recompute (every occupied k-tile x full f_pad) plus the
    # aggregation dots: the fused grid runs *every* row block at every
    # visited step (empty blocks expand to zeros).
    flops = (
        2.0 * occ_kb * block_k * f_in * f_pad
        + 2.0 * n_rb * occ_kb * block_rows * stats.tau * f_pad
    )
    grid_steps = n_fb * occ_kb
    # The fused prologue gathers the layer *input* at F_in width.
    coll_bytes = _epilogue_bytes(stats, f, f_in, n_shards, out_layout,
                                 dense_layout, dtype_bytes, act_bytes)

    shards = max(n_shards, 1)
    imb = max(float(shard_imbalance), 1.0)
    compute, memory, collective, dominant = roofline_seconds(
        flops / shards * imb, dram_bytes / shards * imb, coll_bytes, device
    )
    compute += (grid_steps / shards) * imb * device.step_overhead_s
    if compute > max(memory, collective):
        dominant = "compute"
    return CostBreakdown(
        flops=flops,
        dram_bytes=dram_bytes,
        collective_bytes=coll_bytes,
        sram_pj=(x_bytes + w_bytes + out_bytes)
        * sram_pj_per_byte(device.dense_buffer_bytes)
        + sparse_bytes * sram_pj_per_byte(device.sparse_buffer_bytes),
        dram_pj=dram_bytes * device.dram_pj_per_byte,
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        dominant=dominant,
    )


def fused_layer_seconds(
    stats: GraphStats, f_in: int, f_out: int, **kw
) -> float:
    """Seconds of one fused layer — argmin-ready scalar."""
    return fused_layer_cost(stats, f_in, f_out, **kw).seconds


def fused_viable(
    stats: GraphStats,
    f_in: int,
    *,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    precision: str = "f32",
    n_shards: int = 1,
    device: Optional[DeviceModel] = None,
    headroom: float = 0.9,
    impl: str = "cuda",
) -> bool:
    """Can the fused launch run?

    Under the Pallas model: does its resident footprint fit in VMEM
    (``headroom`` reserves a fraction for the compiler's own scratch)?
    Under the CUDA kernel model: does the kernel's fixed shared-memory
    tile (with the sparse grid's k-tile bitmap for ``impl="cuda_sparse"``)
    fit one CTA — whatever the graph's size.
    """
    device = model_or_default(device)
    if device.cuda is not None:
        n_kb = (_ceil_div(stats.n_dense_rows, block_k)
                if impl == "cuda_sparse" else 0)
        # two ints of static shared memory beside the dynamic bytes
        need = fv.fused_smem_bytes(_act_dtype(precision), n_kb) + 8
        return need <= device.vmem_bytes
    return fused_vmem_bytes(
        stats.padded_rows, stats.tau, f_in,
        block_rows=block_rows, block_k=block_k, block_f=block_f,
        precision=precision, n_shards=n_shards,
    ) <= device.vmem_bytes * headroom


def bucket_forward_seconds(
    rows: int,
    n_out_rows: int,
    mean_row_nnz: float,
    tau: int,
    f_dims: Sequence[int],
    *,
    impl: str = "reference",
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    precision: str = "f32",
    device: Optional[DeviceModel] = None,
) -> float:
    """Seconds of one forward over a *planned* serving-bucket shape:
    ``rows`` ELL sub-rows at the graph's mean occupancy, one SpMM per
    entry of ``f_dims`` (each layer's output width).

    The single bucket-cost arithmetic behind the ladder growth search
    (``plan.autoplan.choose_ladder_growth``) and the engine's per-rung
    precision pick.  ``cuda_sparse`` is priced as ``cuda``: a bucket
    exists only as a plan, with no host operand to schedule the
    block-skipping grid from.
    """
    stats = synthetic_stats(
        rows=rows,
        n_out_rows=n_out_rows,
        n_dense_rows=n_out_rows,
        nnz=max(int(rows * mean_row_nnz), 1),
        tau=tau,
    )
    impl = "cuda" if impl == "cuda_sparse" else impl
    return sum(
        spmm_cost(
            stats, f, impl=impl, block_rows=block_rows, block_k=block_k,
            block_f=block_f, precision=precision, device=model_or_default(device),
        ).seconds
        for f in f_dims
    )


# ---------------------------------------------------------------------------
# Weighted contiguous splits (the sharded path's sub-row partitioner)
# ---------------------------------------------------------------------------


def balanced_split_points(
    weights: Sequence[float], n_parts: int
) -> np.ndarray:
    """Boundaries of the contiguous split of a weighted axis into
    ``n_parts`` segments that minimizes the heaviest segment.

    Returns ``n_parts + 1`` nondecreasing offsets starting at 0 and ending
    at ``len(weights)``.  Exact minimax (binary search on the segment
    capacity, greedy fill per probe on the cumulative sum), so the result
    is never worse-balanced than the uniform equal-count split.
    Zero-weight rows (ELL padding) are free to land on either side of a
    boundary; an all-zero weight vector degrades to the uniform split.
    Deterministic: pure arithmetic, no RNG.
    """
    w = np.asarray(weights, dtype=np.float64)
    n = len(w)
    if n_parts < 1:
        raise ValueError(f"n_parts must be >= 1, got {n_parts}")
    total = float(w.sum())
    if total <= 0.0:
        base = _ceil_div(max(n, 1), n_parts)
        return np.minimum(np.arange(n_parts + 1, dtype=np.int64) * base, n)
    cum = np.cumsum(w)

    def greedy(cap: float) -> np.ndarray:
        """Cut offsets filling every segment up to ``cap`` (cap >= max(w));
        feasible iff the last offset reaches ``n``."""
        bounds = np.empty(n_parts + 1, dtype=np.int64)
        bounds[0] = 0
        base = 0.0
        for s in range(1, n_parts + 1):
            j = min(int(np.searchsorted(cum, base + cap, side="right")), n)
            bounds[s] = j
            base = cum[j - 1] if j > 0 else 0.0
        return bounds

    lo = max(float(w.max()), total / n_parts)   # minimax lower bound
    hi = total                                  # one segment always fits
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if greedy(mid)[-1] >= n:
            hi = mid
        else:
            lo = mid
    bounds = greedy(hi)
    bounds[-1] = n
    return np.maximum.accumulate(bounds)


def width_imbalance(stats: GraphStats, width: int) -> float:
    """max/mean nonzeros per shard of the nnz-weighted ``width``-way split
    the sharded executor uses (1.0 at width 1 or without per-row counts):
    the factor a width's per-device terms are scaled by.  Memoized on
    ``stats``."""
    if width <= 1 or stats.row_nnz is None:
        return 1.0
    return stats._memo(("imbalance", width), lambda: split_imbalance(
        stats.row_nnz, balanced_split_points(stats.row_nnz, width)))


def split_imbalance(weights: Sequence[float], bounds: np.ndarray) -> float:
    """max-segment / mean-segment weight ratio (1.0 = perfectly balanced);
    empty segments contribute 0."""
    w = np.asarray(weights, dtype=np.float64)
    cum = np.concatenate(([0.0], np.cumsum(w)))
    bounds = np.asarray(bounds, dtype=np.int64)
    seg = cum[bounds[1:]] - cum[bounds[:-1]]
    mean = w.sum() / max(len(bounds) - 1, 1)
    return float(seg.max() / mean) if mean > 0 else 1.0


# ---------------------------------------------------------------------------
# Partition-spec scoring
# ---------------------------------------------------------------------------


def spec_shard_factor(axis_sizes: Mapping[str, int], spec: Sequence) -> int:
    """Number of distinct shards a spec cuts an array into, on a mesh of
    ``axis_sizes`` (axis name -> size; the reference takes a JAX mesh)."""
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            factor *= int(axis_sizes[name])
    return factor


def grad_sync_bytes(axis_sizes: Mapping[str, int], shape: Sequence[int],
                    spec: Sequence, dtype_bytes: int = 4) -> float:
    """Estimated per-device collective bytes to keep one leaf in sync.

    A leaf sharded ``factor`` ways is replicated across ``N / factor``
    devices; each step its replicated bytes ride a ring all-reduce:
    ``2 * (bytes/factor) * (r-1)/r``.  Strictly decreasing in the shard
    factor, so the argmin prefers the most-sharded viable candidate.
    """
    n_devices = int(math.prod(dict(axis_sizes).values()))
    leaf_bytes = float(math.prod(shape) if len(shape) else 1) * dtype_bytes
    factor = spec_shard_factor(axis_sizes, spec)
    replicas = max(n_devices // max(factor, 1), 1)
    return 2.0 * (leaf_bytes / max(factor, 1)) * (replicas - 1) / replicas


def rank_specs(axis_sizes: Mapping[str, int], shape: Sequence[int],
               specs: Sequence[Sequence], dtype_bytes: int = 4) -> int:
    """Index of the cheapest candidate spec by estimated collective bytes.

    Stable: earlier candidates win ties, so callers that order candidates
    most-preferred-first keep their choice whenever the model is
    indifferent.
    """
    if not specs:
        raise ValueError("rank_specs needs at least one candidate")
    best_idx, best_cost = 0, None
    for i, spec in enumerate(specs):
        c = grad_sync_bytes(axis_sizes, shape, spec, dtype_bytes)
        if best_cost is None or c < best_cost:
            best_idx, best_cost = i, c
    return best_idx
