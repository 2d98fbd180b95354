"""Launch schedules for the block-skipping kernels.

A numpy copy of the kernel-grid half of ``repro.core.dataflow``.  The
outputs equal the reference's exactly; ``plan_kernel_grid`` builds its
pair list with array operations instead of a Python loop over every
(row block, k-tile) cell, so it stays fast at hundreds of millions of
cells.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sparse_formats import PAD_COL, TiledELL, _ceil_div


@dataclasses.dataclass(frozen=True)
class KernelGrid:
    """Schedule for the block-skipping aggregation kernel.

    ``pairs`` enumerates the non-empty (row_block, k_tile) cells with all
    k-tiles of a row block consecutive, hot k-tiles first; ``first_k``
    flags the first visit of each row block.
    """

    block_rows: int
    block_k: int
    block_f: int
    pairs: np.ndarray     # (n_steps, 2) int32 [row_block, k_tile]
    first_k: np.ndarray   # (n_steps,) bool
    n_row_blocks: int
    n_k_tiles: int
    n_f_tiles: int
    density: float        # visited fraction of the dense grid


def _k_order(ell: TiledELL, block_k: int, n_kb: int, hot_k_first: bool) -> np.ndarray:
    """k-tiles by descending nonzero count (stable), or in index order."""
    if not hot_k_first:
        return np.arange(n_kb)
    valid = ell.cols != PAD_COL
    kb_of = np.where(valid, ell.cols // block_k, 0)
    counts = np.bincount(kb_of[valid].ravel(), minlength=n_kb)
    return np.argsort(-counts, kind="stable")


def plan_kernel_grid(
    ell: TiledELL,
    feature_dim: int,
    block_rows: int = 128,
    block_k: int = 128,
    block_f: int = 128,
    skip_empty: bool = True,
    hot_k_first: bool = True,
) -> KernelGrid:
    """Build the compacted launch schedule from the ELL block occupancy.

    A row block with no occupied k-tile keeps one visit (to the hottest
    k-tile) so its output is still zeroed.
    """
    occ = ell.block_occupancy(block_rows, block_k)
    n_rb, n_kb = occ.shape
    if not skip_empty:
        occ = np.ones_like(occ)
    k_order = _k_order(ell, block_k, n_kb, hot_k_first)
    if n_kb:
        occ_o = occ[:, k_order]
        occ_o[~occ_o.any(axis=1), 0] = True
        rb, pos = np.nonzero(occ_o)
        kb = k_order[pos]
    else:
        rb, kb = np.arange(n_rb), np.zeros(n_rb, dtype=np.int64)
    first = np.ones(rb.shape[0], dtype=bool)
    first[1:] = rb[1:] != rb[:-1]
    pairs = np.stack([rb, kb], axis=1).astype(np.int32).reshape(-1, 2)
    return KernelGrid(
        block_rows=block_rows,
        block_k=block_k,
        block_f=block_f,
        pairs=pairs,
        first_k=first,
        n_row_blocks=n_rb,
        n_k_tiles=n_kb,
        n_f_tiles=_ceil_div(feature_dim, block_f),
        density=float(len(pairs)) / float(max(n_rb * n_kb, 1)),
    )


def plan_fused_k_schedule(
    ell: TiledELL,
    block_rows: int = 128,
    block_k: int = 128,
    hot_k_first: bool = True,
) -> np.ndarray:
    """k-tile visit order for the fused launch: every k-tile occupied by any
    row, in the same global hot-first order ``plan_kernel_grid`` applies
    within each row block."""
    occ_any = ell.block_occupancy(block_rows, block_k).any(axis=0)
    n_kb = occ_any.shape[0]
    k_order = _k_order(ell, block_k, n_kb, hot_k_first)
    kbs = [int(kb) for kb in k_order if occ_any[kb]]
    if not kbs:  # fully-empty matrix: one step keeps the init path alive
        kbs = [0]
    return np.asarray(kbs, dtype=np.int32)
