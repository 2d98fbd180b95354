"""Hybrid graph preprocessing: edge-cut tiles, then the Algorithm 1 vertex-cut.

A numpy copy of ``repro.core.preprocessing`` (the parts ``preprocess``
runs); the outputs are exactly the reference's.

1. **Inter-tile edge-cut** — a reverse Cuthill–McKee (RCM) symmetric
   permutation stands in for METIS; contiguous row tiles of the permuted
   matrix keep cross-tile edges few.
2. **Intra-tile vertex-cut (Algorithm 1)** — rows with more than ``tau``
   nonzeros are split into ceil(RNZ/tau) sub-rows, spreading the misses
   (columns outside the tile's ``tau`` hottest) evenly across the splits.
   Split rows carry a ``row_map`` entry back to the original row.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
from scipy.sparse.csgraph import reverse_cuthill_mckee

from repro_torch.core.sparse_formats import (
    CSRMatrix,
    TiledELL,
    _ceil_div,
    csr_rows_to_ell,
)


# ---------------------------------------------------------------------------
# Inter-tile edge-cut
# ---------------------------------------------------------------------------


def edge_cut_permutation(adj: CSRMatrix, method: str = "rcm") -> np.ndarray:
    """Compute a locality-preserving node permutation.

    ``rcm``    — reverse Cuthill–McKee bandwidth minimization.
    ``degree`` — descending-degree order (groups supernodes together).
    ``none``   — identity.
    """
    n = adj.rows
    if method == "none":
        return np.arange(n)
    if method == "degree":
        deg = adj.row_nnz() + adj.col_nnz()[:n] if adj.cols == n else adj.row_nnz()
        return np.argsort(-deg, kind="stable")
    if method == "rcm":
        m = adj.to_scipy()
        sym = (m + m.T).tocsr() if m.shape[0] == m.shape[1] else m
        perm = reverse_cuthill_mckee(sym.astype(np.float64), symmetric_mode=True)
        return np.asarray(perm, dtype=np.int64)
    raise ValueError(f"unknown edge-cut method: {method}")


def apply_symmetric_permutation(adj: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Permute rows and columns of a square adjacency by ``perm``."""
    m = adj.to_scipy()
    out = m[perm][:, perm] if m.shape[0] == m.shape[1] else m[perm]
    return CSRMatrix.from_scipy(out.tocsr())


@dataclasses.dataclass(frozen=True)
class Tile:
    """One inter-tile edge-cut tile: ``rows`` sparse rows of the operand.

    ``col_ids`` are *global* dense-row indices touched by the tile;
    ``local_rows_cols[r]`` hold, per row, indices into ``col_ids``.
    """

    row_start: int
    rows: int
    col_ids: np.ndarray                # (tile_cols,) global dense-row indices
    local_rows_cols: List[np.ndarray]  # per-row tile-local column indices
    local_rows_vals: List[np.ndarray]  # per-row values

    def cnz(self) -> np.ndarray:
        """Nonzeros per tile-local column (Algorithm 1's hotness input)."""
        counts = np.zeros(len(self.col_ids), dtype=np.int64)
        for c in self.local_rows_cols:
            np.add.at(counts, c, 1)
        return counts


def partition_into_tiles(adj: CSRMatrix, tile_rows: int) -> List[Tile]:
    """Cut the (already permuted) operand into row tiles of ``tile_rows``.

    Each tile's columns are compacted to the set actually touched.
    """
    tiles: List[Tile] = []
    for start in range(0, adj.rows, tile_rows):
        stop = min(start + tile_rows, adj.rows)
        lo, hi = adj.indptr[start], adj.indptr[stop]
        g_cols = adj.indices[lo:hi]
        g_vals = adj.data[lo:hi]
        uniq, local = np.unique(g_cols, return_inverse=True)
        rows_cols, rows_vals = [], []
        off = 0
        for r in range(start, stop):
            n = int(adj.indptr[r + 1] - adj.indptr[r])
            rows_cols.append(local[off : off + n].astype(np.int32))
            rows_vals.append(np.asarray(g_vals[off : off + n]))
            off += n
        tiles.append(
            Tile(
                row_start=start,
                rows=stop - start,
                col_ids=uniq.astype(np.int64),
                local_rows_cols=rows_cols,
                local_rows_vals=rows_vals,
            )
        )
    return tiles


# ---------------------------------------------------------------------------
# Intra-tile vertex-cut — Algorithm 1
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VertexCutTile:
    """Tile after Algorithm 1: no (sub-)row exceeds tau nonzeros."""

    tile: Tile
    sub_rows_cols: List[np.ndarray]  # tile-local col indices per sub-row
    sub_rows_vals: List[np.ndarray]
    sub_row_map: np.ndarray          # (n_sub_rows,) -> global output row
    tau: int


def _hot_columns(cnz: np.ndarray, tau: int) -> np.ndarray:
    """Columns assumed resident under an ideal VRF of depth tau (Alg 1)."""
    k = min(tau, cnz.size)
    return np.argsort(-cnz, kind="stable")[:k]


def vertex_cut_tile(tile: Tile, tau: int) -> VertexCutTile:
    """Algorithm 1: intra-tile vertex-cut workload balancing.

    Rows with RNZ <= tau pass through.  A row with RNZ > tau is split into
    K = ceil(RNZ/tau) sub-rows; its columns are classified into a MissList
    (not among the tau hottest of the tile) and a HitList, and each
    sub-row pops n_miss = ceil(|Miss|/K) misses plus n_hit = tau - n_miss
    hits.
    """
    if tau < 1:
        raise ValueError("tau must be >= 1")
    cnz = tile.cnz()
    hot = set(_hot_columns(cnz, tau).tolist())

    sub_cols: List[np.ndarray] = []
    sub_vals: List[np.ndarray] = []
    sub_map: List[int] = []
    for local_r, (cols, vals) in enumerate(
        zip(tile.local_rows_cols, tile.local_rows_vals)
    ):
        g_row = tile.row_start + local_r
        rnz = len(cols)
        if rnz <= tau:
            sub_cols.append(cols)
            sub_vals.append(vals)
            sub_map.append(g_row)
            continue
        # Step 1: separate miss/hit indices for this row.
        is_hit = np.fromiter((c in hot for c in cols.tolist()), dtype=bool, count=rnz)
        miss_list = list(np.nonzero(~is_hit)[0])
        hit_list = list(np.nonzero(is_hit)[0])
        k_splits = _ceil_div(rnz, tau)
        n_miss = _ceil_div(len(miss_list), k_splits)
        n_hit = tau - n_miss
        # Step 2: distribute into sub-rows.
        for _ in range(k_splits):
            take_m = [miss_list.pop(0) for _ in range(min(n_miss, len(miss_list)))]
            take_h = [hit_list.pop(0) for _ in range(min(n_hit, len(hit_list)))]
            idx = np.array(take_m + take_h, dtype=np.int64)
            if idx.size == 0:
                continue
            sub_cols.append(cols[idx])
            sub_vals.append(vals[idx])
            sub_map.append(g_row)
        # Leftovers (pop shortfall) go into extra sub-rows of <= tau each.
        rest = miss_list + hit_list
        while rest:
            idx = np.array(rest[:tau], dtype=np.int64)
            rest = rest[tau:]
            sub_cols.append(cols[idx])
            sub_vals.append(vals[idx])
            sub_map.append(g_row)

    return VertexCutTile(
        tile=tile,
        sub_rows_cols=sub_cols,
        sub_rows_vals=sub_vals,
        sub_row_map=np.array(sub_map, dtype=np.int32),
        tau=tau,
    )


# ---------------------------------------------------------------------------
# Whole-matrix pipeline -> kernel-facing ELL
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PreprocessResult:
    """Output of the full hybrid preprocessing pipeline."""

    ell: TiledELL                  # bounded-row sparse operand (global cols)
    perm: np.ndarray               # node permutation applied (edge-cut)
    tiles: List[VertexCutTile]     # per-tile views
    tau: int
    tile_rows: int


def preprocess(
    adj: CSRMatrix,
    tau: int,
    tile_rows: int = 16,
    edge_cut: str = "rcm",
    pad_rows_to: int = 1,
    dtype=np.float32,
) -> PreprocessResult:
    """Full hybrid pipeline: edge-cut -> tiles -> vertex-cut -> ELL.

    The returned ELL carries *global* column indices (into the permuted
    dense operand) so a single kernel launch covers the whole matrix.
    """
    perm = edge_cut_permutation(adj, edge_cut)
    padj = apply_symmetric_permutation(adj, perm) if edge_cut != "none" else adj
    tiles = partition_into_tiles(padj, tile_rows)
    vc_tiles = [vertex_cut_tile(t, tau) for t in tiles]

    row_cols: List[np.ndarray] = []
    row_vals: List[np.ndarray] = []
    row_map: List[int] = []
    for vt in vc_tiles:
        col_ids = vt.tile.col_ids
        for c, v, m in zip(vt.sub_rows_cols, vt.sub_rows_vals, vt.sub_row_map):
            row_cols.append(col_ids[c].astype(np.int32))
            row_vals.append(v)
            row_map.append(int(m))
    ell = csr_rows_to_ell(
        row_cols,
        row_vals,
        row_map,
        tau=tau,
        n_dense_rows=padj.cols,
        n_orig_rows=padj.rows,
        pad_rows_to=pad_rows_to,
        dtype=dtype,
    )
    return PreprocessResult(
        ell=ell, perm=perm, tiles=vc_tiles, tau=tau, tile_rows=tile_rows
    )
