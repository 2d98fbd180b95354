"""Sparse matrix formats: host CSR and the kernel-facing tiled ELL.

A numpy copy of ``repro.core.sparse_formats``.  After the intra-tile vertex-cut (Algorithm 1) every (sub-)row
holds at most ``tau`` nonzeros, so the sparse operand is re-encoded as a
dense ``(rows, tau)`` table of (column, value) pairs — the ELL format the
CUDA kernels gather from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

# Sentinel column index used for ELL padding slots.
PAD_COL = -1


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Minimal host-side CSR container (row-major, sorted column indices)."""

    indptr: np.ndarray   # (rows + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    def row_nnz(self) -> np.ndarray:
        """RNZ: number of nonzeros per sparse row."""
        return np.diff(self.indptr).astype(np.int64)

    def col_nnz(self) -> np.ndarray:
        """CNZ: number of nonzeros per column."""
        return np.bincount(self.indices, minlength=self.shape[1]).astype(np.int64)

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    @staticmethod
    def from_scipy(mat: sp.spmatrix) -> "CSRMatrix":
        m = sp.csr_matrix(mat)
        m.sort_indices()
        return CSRMatrix(
            indptr=m.indptr.astype(np.int64),
            indices=m.indices.astype(np.int32),
            data=np.asarray(m.data),
            shape=m.shape,
        )


@dataclasses.dataclass(frozen=True)
class TiledELL:
    """Bounded-row sparse (ELL) matrix, the kernel-facing format.

    Every row has at most ``tau`` nonzeros; padding slots carry
    ``col == PAD_COL`` and ``val == 0``.  ``row_map`` maps each (sub-)row
    back to its original output row; rows the vertex-cut split have their
    partial outputs summed by ``segment_accumulate``.
    """

    cols: np.ndarray      # (padded_rows, tau) int32, PAD_COL for empty slots
    vals: np.ndarray      # (padded_rows, tau) float32
    row_map: np.ndarray   # (padded_rows,) int32 -> original row (or -1 padding)
    n_dense_rows: int     # K dimension (number of dense rows the cols index)
    n_orig_rows: int      # output row count before vertex-cut/padding

    @property
    def tau(self) -> int:
        return int(self.cols.shape[1])

    @property
    def padded_rows(self) -> int:
        return int(self.cols.shape[0])

    @property
    def nnz(self) -> int:
        return int((self.cols != PAD_COL).sum())

    def block_occupancy(self, block_rows: int, block_k: int) -> np.ndarray:
        """Boolean map of shape (n_row_blocks, n_k_blocks).

        ``occupancy[rb, kb]`` is True iff some nonzero of row-block ``rb``
        has a column inside k-tile ``kb``; the block-skipping schedules
        visit only those (row-block, k-tile) pairs.
        """
        n_rb = _ceil_div(self.padded_rows, block_rows)
        n_kb = _ceil_div(self.n_dense_rows, block_k)
        occ = np.zeros((n_rb, n_kb), dtype=bool)
        valid = self.cols != PAD_COL
        rb_idx = np.repeat(
            np.arange(self.padded_rows) // block_rows, self.tau
        ).reshape(self.cols.shape)
        kb_idx = np.where(valid, self.cols // block_k, 0)
        occ[rb_idx[valid], kb_idx[valid]] = True
        return occ


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def csr_rows_to_ell(
    row_cols: list,
    row_vals: list,
    row_map: list,
    tau: int,
    n_dense_rows: int,
    n_orig_rows: int,
    pad_rows_to: int = 1,
    dtype=np.float32,
) -> TiledELL:
    """Assemble an ELL matrix from per-row index/value lists.

    Raises if any row exceeds ``tau`` nonzeros — callers must vertex-cut
    first (Algorithm 1 guarantees RNZ <= tau).
    """
    n = len(row_cols)
    padded = _ceil_div(max(n, 1), pad_rows_to) * pad_rows_to
    cols = np.full((padded, tau), PAD_COL, dtype=np.int32)
    vals = np.zeros((padded, tau), dtype=dtype)
    rmap = np.full((padded,), -1, dtype=np.int32)
    for i, (c, v) in enumerate(zip(row_cols, row_vals)):
        if len(c) > tau:
            raise ValueError(
                f"row {i} has RNZ={len(c)} > tau={tau}; run vertex-cut first"
            )
        cols[i, : len(c)] = c
        vals[i, : len(c)] = v
        rmap[i] = row_map[i]
    return TiledELL(
        cols=cols,
        vals=vals,
        row_map=rmap,
        n_dense_rows=n_dense_rows,
        n_orig_rows=n_orig_rows,
    )


def csr_to_ell(
    mat: CSRMatrix,
    tau: Optional[int] = None,
    pad_rows_to: int = 1,
) -> TiledELL:
    """Directly re-encode a CSR matrix whose max RNZ already fits ``tau``."""
    rnz = mat.row_nnz()
    max_rnz = int(rnz.max()) if rnz.size else 0
    if tau is None:
        tau = max(max_rnz, 1)
    if max_rnz > tau:
        raise ValueError(f"max RNZ {max_rnz} exceeds tau {tau}")
    n = mat.rows
    padded = _ceil_div(max(n, 1), pad_rows_to) * pad_rows_to
    cols = np.full((padded, tau), PAD_COL, dtype=np.int32)
    vals = np.zeros((padded, tau), dtype=mat.data.dtype)
    rmap = np.full((padded,), -1, dtype=np.int32)
    rmap[:n] = np.arange(n, dtype=np.int32)
    # each nonzero's slot: its position inside its row
    pos = np.arange(mat.nnz) - np.repeat(mat.indptr[:-1], rnz)
    rows = np.repeat(np.arange(n), rnz)
    cols[rows, pos] = mat.indices
    vals[rows, pos] = mat.data
    return TiledELL(
        cols=cols,
        vals=vals,
        row_map=rmap,
        n_dense_rows=mat.cols,
        n_orig_rows=n,
    )


def ell_to_dense(ell: TiledELL) -> np.ndarray:
    """Expand an ELL matrix to a dense f64 (orig_rows, n_dense_rows) array,
    the sub-rows of a vertex-cut row summed (a test oracle)."""
    out = np.zeros((ell.n_orig_rows, ell.n_dense_rows), dtype=np.float64)
    valid = ell.cols != PAD_COL
    rows = np.broadcast_to(ell.row_map[:, None], ell.cols.shape)[valid]
    np.add.at(out, (rows, ell.cols[valid]), ell.vals[valid].astype(np.float64))
    return out


def random_power_law_csr(
    rows: int,
    cols: int,
    nnz: int,
    alpha: float = 2.1,
    seed: int = 0,
    dtype=np.float32,
) -> CSRMatrix:
    """Random sparse matrix with power-law column popularity.

    Column probabilities follow p(c) ∝ (c+1)^-alpha after a random
    permutation, concentrating nonzeros in a few "supernode" columns the
    way real GCN adjacency matrices do.
    """
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(cols)
    p = (ranks + 1.0) ** (-alpha)
    p /= p.sum()
    r = rng.integers(0, rows, size=nnz)
    c = rng.choice(cols, size=nnz, p=p)
    v = rng.standard_normal(nnz).astype(dtype)
    mat = sp.csr_matrix((v, (r, c)), shape=(rows, cols))
    mat.sum_duplicates()
    return CSRMatrix.from_scipy(mat)
