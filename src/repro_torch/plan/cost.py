"""Graph statistics for plan decisions.

A numpy copy of the part of ``repro.plan.cost`` the serving bucket ladder
needs: :class:`GraphStats`, :func:`graph_stats_from_ell` and
:func:`synthetic_stats`.  The reference's device model and cost terms
(``DeviceModel``, ``spmm_cost``, ``bucket_forward_seconds``, ...) are not
ported yet: they are the planning slice's, with a Hopper device model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.sparse_formats import PAD_COL, TiledELL


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """The sparse-operand statistics every cost term is a function of
    (the reference's block-occupancy counters come with the cost terms
    that read them)."""

    padded_rows: int            # ELL rows incl. block padding
    n_sub_rows: int             # real (row_map >= 0) vertex-cut sub-rows
    n_out_rows: int             # original output rows
    n_dense_rows: int           # K dimension
    nnz: int
    tau: int
    row_nnz: Optional[np.ndarray] = None   # (padded_rows,) valid counts
    ell: Optional[TiledELL] = None         # exact block occupancy, if host

    @property
    def rows_per_node(self) -> int:
        """Vertex-cut expansion factor: padded sub-rows per output row —
        the serving bucket ladder's ELL-row budget per node."""
        return _ceil_div(self.padded_rows, max(self.n_out_rows, 1))

    @property
    def mean_row_nnz(self) -> float:
        return self.nnz / max(self.n_sub_rows, 1)


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
