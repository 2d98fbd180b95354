"""Per-tile statistics for the instruction-driven simulator, on a device.

The port's copy of ``repro.sim.blockstats``: a *tile* is a ``tile x
tile`` sub-matrix of the (edge-cut permuted) sparse operand, the unit
the coarse-grained ISA processes (paper Fig 5).  Everything is O(nnz)
passes over sorted arrays, here ``torch`` sorts, cumulative sums and
scatters on the device the statistics live on, so Reddit's 24 M
nonzeros are grouped on the card:

* per-nnz: owning tile, row-in-tile, and the *column rank* — the
  position of the nonzero's column among the tile's columns sorted by
  CNZ descending (Algorithm 2's ``Sorted_CNZ``; rank < k <=> a hit in
  the VRF fixed region);
* per-(tile,row): RNZ and, for any candidate k, the miss count;
* per-tile: nnz, distinct columns, rows, and Algorithm 2's ``best_k``;
* per row-panel group: distinct dense-row loads.

Every array equals the reference's, dtype included: the sorts are
stable on combined int64 keys (ties by input order, as numpy's
``lexsort`` / ``kind="stable"`` break them), and every segmented sum is
an exact integer sum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.device import resolve_device


def _ceil_div(a: torch.Tensor, b) -> torch.Tensor:
    return -(-a // b)


def _firsts(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """Mask of the first element of each run of equal (sorted) key tuples."""
    first = torch.ones_like(sorted_keys[0], dtype=torch.bool)
    if len(first):
        diff = sorted_keys[0][1:] != sorted_keys[0][:-1]
        for k in sorted_keys[1:]:
            diff |= k[1:] != k[:-1]
        first[1:] = diff
    return first


def _run_lengths(starts: torch.Tensor, total: int) -> torch.Tensor:
    return torch.diff(starts, append=starts.new_tensor([total]))


def _segment_ids(starts: torch.Tensor, total: int) -> torch.Tensor:
    """Per-element segment index for segments beginning at ``starts``."""
    marks = torch.zeros(total, dtype=torch.int64, device=starts.device)
    marks[starts] = 1
    return torch.cumsum(marks, 0) - 1


@dataclasses.dataclass
class BlockStats:
    """Sorted-array view of the tile decomposition of one sparse operand.

    All per-nnz tensors are ordered by (tile, row-in-tile, col-rank) and
    live on one device (:attr:`device`).
    """

    tile: int
    n_rows: int
    n_cols: int
    nnz: int

    # per-nnz (sorted by tile, then row-in-tile, then col rank)
    nz_block: torch.Tensor      # (nnz,) int32 tile id
    nz_col_rank: torch.Tensor   # (nnz,) int32 CNZ-desc rank of the column
    nz_col: torch.Tensor        # (nnz,) int32 global column
    nz_rb: torch.Tensor         # (nnz,) int32 row-panel (row // tile)

    # per-(tile,row) groups (contiguous in the nnz order)
    br_start: torch.Tensor      # (n_br,) int64 offsets into nnz arrays
    br_block: torch.Tensor      # (n_br,) int32
    br_rnz: torch.Tensor        # (n_br,) int32

    # per-tile groups (contiguous in the (tile,row) order)
    b_start: torch.Tensor       # (n_b,) int64 offsets into br arrays
    b_nnz_start: torch.Tensor   # (n_b,) int64 offsets into nnz arrays
    b_nnz: torch.Tensor         # (n_b,) int64
    b_ncols: torch.Tensor       # (n_b,) int32 distinct columns touched
    b_nrows: torch.Tensor       # (n_b,) int32 rows with nonzeros

    _memo: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_blocks(self) -> int:
        return len(self.b_nnz)

    @property
    def device(self) -> torch.device:
        return self.nz_block.device

    def _ids(self, name: str) -> torch.Tensor:
        """Per-nnz (tile,row) index (``"br"``) or per-(tile,row) tile index
        (``"b"``), built once."""
        if name not in self._memo:
            starts, total = ((self.br_start, self.nnz) if name == "br"
                             else (self.b_start, len(self.br_rnz)))
            self._memo[name] = _segment_ids(starts, total)
        return self._memo[name]

    # ------------------------------------------------------------------
    def _reduce(self, values: torch.Tensor, name: str, how: str) -> torch.Tensor:
        starts = self.br_start if name == "br" else self.b_start
        if how == "sum":
            # groups are contiguous and non-empty: differences of the
            # running sum at each group's last element (exact, no atomics)
            cs = torch.cumsum(values.to(torch.int64), 0)
            if not len(starts):
                return cs
            ends = torch.cat([starts[1:], starts.new_tensor([len(values)])])
            total = cs[ends - 1]
            return torch.diff(total, prepend=total.new_zeros(1))
        if how == "max":
            out = torch.empty(len(starts), dtype=values.dtype,
                              device=values.device)
            return out.scatter_reduce_(0, self._ids(name), values, "amax",
                                       include_self=False)
        raise KeyError(how)

    def br_reduce(self, values: torch.Tensor, how: str = "sum") -> torch.Tensor:
        """Reduce a per-nnz tensor into per-(tile,row) groups (sums in
        int64, as numpy's ``add.reduceat`` gives them; maxima keep the
        dtype)."""
        return self._reduce(values, "br", how)

    def b_reduce(self, values_br: torch.Tensor, how: str = "sum") -> torch.Tensor:
        """Reduce a per-(tile,row) tensor into per-tile groups."""
        return self._reduce(values_br, "b", how)

    # ------------------------------------------------------------------
    def miss_per_block_row(self, k) -> torch.Tensor:
        """Per-(tile,row) miss count when tile b pins its top-k[b] columns.

        ``k`` may be a scalar or per-tile; a nonzero hits iff its column
        rank is below the tile's k.
        """
        if isinstance(k, (int, np.integer)):
            k_nz = int(k)
        else:
            k_nz = torch.as_tensor(k, device=self.device)[self.nz_block.long()]
        hit = (self.nz_col_rank < k_nz).to(torch.int32)
        return self.br_rnz - self.br_reduce(hit, "sum")

    def br_block_rank(self) -> torch.Tensor:
        """Dense per-(tile,row) tile index."""
        return self._ids("b")

    # ------------------------------------------------------------------
    def top2_per_block(
        self, values_br: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(max, 2nd max) of a per-(tile,row) tensor within each tile.

        The second max is 0 for single-row tiles: the first in-tile
        occurrence of the max is masked out, then a second max runs.
        """
        m0 = self.b_reduce(values_br, "max")
        seg = self.br_block_rank()
        is_max = (values_br == m0[seg]).to(torch.int64)
        c = torch.cumsum(is_max, 0)
        base = torch.zeros(len(m0), dtype=torch.int64, device=c.device)
        base[1:] = c[self.b_start[1:] - 1]
        first_occ = (is_max == 1) & ((c - base[seg]) == 1)
        v2 = torch.where(first_occ, torch.full_like(values_br, -1), values_br)
        m1 = self.b_reduce(v2, "max")
        return m0, torch.clamp(m1, min=0)

    # ------------------------------------------------------------------
    def unique_group_loads(self, group: int) -> int:
        """Distinct (panel-group, column) pairs: DRAM dense-row loads when
        ``group`` consecutive row panels share the multi-buffered
        Rows-to-Compute region (Fig 12b amortization)."""
        g = self.nz_rb.to(torch.int64) // max(group, 1)
        key = g * (self.n_cols + 1) + self.nz_col
        return int(len(torch.unique(key)))


def compute_block_stats(
    adj: CSRMatrix, tile: int,
    device: Optional[Union[str, torch.device]] = None,
) -> BlockStats:
    """Decompose a CSR operand into ``tile`` x ``tile`` tiles on ``device``
    (the card unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    nnz = adj.nnz
    rnz = torch.as_tensor(adj.row_nnz(), device=dev)
    rows = torch.repeat_interleave(
        torch.arange(adj.rows, dtype=torch.int64, device=dev), rnz)
    cols = torch.as_tensor(adj.indices, device=dev).to(torch.int64)
    n_cb = -(-adj.cols // tile)
    panel = (rows // tile) * n_cb + cols // tile   # tile id (row-major)

    # ---- pass 1: per-(tile,col) counts -> column ranks ---------------
    key1, order1 = torch.sort(panel * (adj.cols + 1) + cols, stable=True)
    pk1 = key1 // (adj.cols + 1)
    entry_new = _firsts(key1)
    del key1
    entry_id = torch.cumsum(entry_new.to(torch.int64), 0) - 1
    entry_starts = torch.nonzero(entry_new).flatten()
    del entry_new
    entry_panel = pk1[entry_starts]
    entry_count = _run_lengths(entry_starts, nnz)
    del pk1, entry_starts
    # rank entries within their tile by count desc (ties: column order)
    assert tile <= 1024, "rank key assumes tile <= 1024"
    rorder = torch.sort(entry_panel * 2048 + (tile - entry_count),
                        stable=True).indices
    pan_sorted = entry_panel[rorder]
    pan_new = _firsts(pan_sorted)
    pan_first_pos = torch.nonzero(pan_new).flatten()
    pan_of_entry_sorted = torch.cumsum(pan_new.to(torch.int64), 0) - 1
    rank_sorted = (torch.arange(len(rorder), device=dev)
                   - pan_first_pos[pan_of_entry_sorted])
    entry_rank = torch.empty(len(rorder), dtype=torch.int32, device=dev)
    entry_rank[rorder] = rank_sorted.to(torch.int32)
    del rorder, pan_sorted, pan_new, pan_first_pos, pan_of_entry_sorted
    del rank_sorted
    col_rank = torch.empty(nnz, dtype=torch.int32, device=dev)
    col_rank[order1] = entry_rank[entry_id]
    del order1, entry_id, entry_rank
    b_keys_c, b_ncols = torch.unique_consecutive(entry_panel,
                                                 return_counts=True)
    del entry_panel, entry_count

    # ---- pass 2: sort by (tile, row, col_rank) ------------------------
    # a tile has at most `tile` columns, so col_rank < tile
    r_in = rows % tile
    order2 = torch.sort((panel * tile + r_in) * tile + col_rank,
                        stable=True).indices
    nz_pk = panel[order2]
    nz_ri = r_in[order2]
    nz_rank = col_rank[order2]
    nz_col = cols[order2].to(torch.int32)
    nz_rb = (rows[order2] // tile).to(torch.int32)
    del rows, cols, panel, r_in, col_rank, order2

    br_start = torch.nonzero(_firsts(nz_pk, nz_ri)).flatten()
    del nz_ri
    br_panel_key = nz_pk[br_start]
    br_rnz = _run_lengths(br_start, nnz).to(torch.int32)
    b_new = _firsts(br_panel_key)
    b_start = torch.nonzero(b_new).flatten()
    b_keys = br_panel_key[b_new]
    b_nrows = _run_lengths(b_start, len(br_panel_key)).to(torch.int32)
    b_nnz_start = br_start[b_start]
    b_nnz = _run_lengths(b_nnz_start, nnz)
    assert torch.equal(b_keys, b_keys_c)
    del nz_pk, br_panel_key, b_new, b_keys, b_keys_c

    nz_block = _segment_ids(b_nnz_start, nnz).to(torch.int32)
    return BlockStats(
        tile=tile,
        n_rows=adj.rows,
        n_cols=adj.cols,
        nnz=nnz,
        nz_block=nz_block,
        nz_col_rank=nz_rank,
        nz_col=nz_col,
        nz_rb=nz_rb,
        br_start=br_start,
        br_block=nz_block[br_start],
        br_rnz=br_rnz,
        b_start=b_start,
        b_nnz_start=b_nnz_start,
        b_nnz=b_nnz,
        b_ncols=b_ncols.to(torch.int32),
        b_nrows=b_nrows,
    )


# ---------------------------------------------------------------------------
# Algorithm 2 across all tiles
# ---------------------------------------------------------------------------


def alg2_best_k(
    stats: BlockStats,
    tau: int,
    vrf_depth: int,
    mode: str = "double",
    pct: float = 0.5,
) -> torch.Tensor:
    """Per-tile Algorithm 2 ``best_k`` (int32, on the stats' device).

    The published greedy: start at k0 = ceil(tau*pct); if k0 fits, climb
    while consecutive k fit; else descend to the first fitting k.  Fit
    uses the post-vertex-cut per-sub-row miss bound
    ceil(miss / ceil(RNZ/tau)) and requires k + m0 (+ m1 in double mode)
    <= vrf_depth.  One segmented sum over the nonzeros per candidate k.
    """
    n_b = stats.n_blocks
    dev = stats.device
    k_splits = _ceil_div(stats.br_rnz, tau)

    k0 = int(math.ceil(tau * pct))
    k0 = max(1, min(k0, vrf_depth))
    kmax = min(vrf_depth, int(stats.b_ncols.max()) if n_b else 0)
    if kmax < 1:
        return torch.zeros(n_b, dtype=torch.int32, device=dev)

    fit = torch.zeros((kmax + 1, n_b), dtype=torch.bool, device=dev)
    fit[0] = True
    rank = stats.nz_col_rank
    for k in range(1, kmax + 1):
        hits = stats.br_reduce((rank < k).to(torch.int32), "sum")
        v = _ceil_div(stats.br_rnz - hits, k_splits)
        m0, m1 = stats.top2_per_block(v)
        need = k + m0 + (m1 if mode == "double" else 0)
        fit[k] = (need <= vrf_depth) & (k <= stats.b_ncols)

    k0 = min(k0, kmax)
    # climb-up from k0: largest j >= k0 with fit[k0..j] all True
    alive = fit[k0].clone()
    best_up = torch.where(alive, k0, 0)
    for k in range(k0 + 1, kmax + 1):
        alive &= fit[k]
        best_up = torch.where(alive, k, best_up)
    # descend: first fitting k scanning k0-1 .. 1
    best_down = torch.zeros(n_b, dtype=torch.int64, device=dev)
    undecided = ~fit[k0]
    for k in range(k0 - 1, 0, -1):
        sel = undecided & fit[k] & (best_down == 0)
        best_down[sel] = k
    best = torch.where(fit[k0], best_up, best_down)
    return torch.minimum(best, stats.b_ncols.to(torch.int64)).to(torch.int32)
