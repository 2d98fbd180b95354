"""Algorithm 2 — sparsity-aware top-k VRF fixed-region selection.

The port's copy of ``repro.core.topk_select`` (host numpy, one
vertex-cut tile at a time); for the same tile every result equals the
reference's.  ``repro_torch.sim.alg2_best_k`` is the same greedy across
all tiles at once, on a device.

Given a sparse tile, pick how many VRF rows (``k``) to devote to the *fixed*
region holding the k highest-CNZ dense rows; the remainder is the dynamic
region that must still hold the worst-case per-row miss working set (one
row's misses in single-VRF mode, two rows' in double-VRF mode so the next
row's MV_Dyn can overlap the current CMP).

The paper reports this adaptive selection lands within 2% of the best static
k across VRF depths (Fig 11).
"""

from __future__ import annotations

from typing import Literal, Tuple

import numpy as np

from repro_torch.core.preprocessing import VertexCutTile

VRFMode = Literal["single", "double"]


def analyze_cnz(vc: VertexCutTile) -> np.ndarray:
    """Nonzeros per tile-local column across the vertex-cut sub-rows."""
    counts = np.zeros(len(vc.tile.col_ids), dtype=np.int64)
    for c in vc.sub_rows_cols:
        np.add.at(counts, c, 1)
    return counts


def miss_counts(vc: VertexCutTile, fixed_cols: np.ndarray) -> np.ndarray:
    """Per-sub-row count of accesses missing the fixed region."""
    fixed = np.zeros(len(vc.tile.col_ids), dtype=bool)
    if fixed_cols.size:
        fixed[fixed_cols] = True
    return np.array(
        [int((~fixed[c]).sum()) for c in vc.sub_rows_cols], dtype=np.int64
    )


def select_top_k(
    vc: VertexCutTile,
    tau: int,
    vrf_depth: int,
    mode: VRFMode = "double",
    pct: float = 0.5,
) -> int:
    """Algorithm 2: returns best_k, the fixed-region depth for this tile.

    Faithful to the paper's pseudo-code with one engineering guard: the
    published loop can oscillate between a fitting k and a non-fitting k+1,
    so we terminate on revisiting a k (the returned best_k is unaffected).
    """
    cnz = analyze_cnz(vc)
    order = np.argsort(-cnz, kind="stable")
    # Columns with zero reuse cannot help the fixed region.
    n_useful = int((cnz > 0).sum())

    k = int(np.ceil(tau * pct))
    k = max(0, min(k, n_useful, vrf_depth))
    best_k = 0
    seen = set()
    while 0 < k <= vrf_depth and k not in seen:
        seen.add(k)
        topk_idx = order[:k]
        miss = np.sort(miss_counts(vc, topk_idx))[::-1]
        m0 = int(miss[0]) if miss.size > 0 else 0
        m1 = int(miss[1]) if miss.size > 1 else 0
        if mode == "single":
            fit = k + m0 <= vrf_depth
        elif mode == "double":
            fit = k + m0 + m1 <= vrf_depth
        else:
            raise ValueError(f"unknown VRF mode: {mode}")
        if fit:
            best_k = k
            k += 1
        else:
            k -= 1
    return int(min(best_k, n_useful))


def fixed_region_columns(vc: VertexCutTile, k: int) -> np.ndarray:
    """The tile-local column ids pinned in the fixed region for a given k."""
    cnz = analyze_cnz(vc)
    return np.argsort(-cnz, kind="stable")[:k].astype(np.int64)


def tile_miss_profile(
    vc: VertexCutTile, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(miss, hit) counts per sub-row under a fixed region of depth k."""
    fixed = fixed_region_columns(vc, k)
    miss = miss_counts(vc, fixed)
    rnz = vc.rnz()
    return miss, rnz - miss
