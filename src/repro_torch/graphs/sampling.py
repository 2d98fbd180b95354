"""Neighbor sampling over CSR adjacencies (GraphSAGE-style fanout caps).

A numpy copy of ``repro.graphs.sampling``; for the same adjacency, seeds
and generator state every array equals the reference's.  Host-side
primitives used by the serving subsystem: expand a seed set to its k-hop
receptive field (optionally capping the per-node fanout so a supernode
cannot blow up request latency) and extract the induced sub-adjacency.
The serving path passes the *normalized* adjacency, so the induced
operand keeps the global D^-1/2 scaling (no renormalization on the
subgraph).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.sparse_formats import CSRMatrix


def sample_k_hop(
    adj: CSRMatrix,
    seeds: Sequence[int],
    hops: int,
    fanout: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sorted node ids of the (fanout-capped) ``hops``-hop closure of seeds.

    With ``fanout`` None or >= the max degree the result is the exact
    receptive field of a ``hops``-layer GCN; smaller fanouts subsample each
    frontier node's neighbor list without replacement.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    if seeds.size and (seeds.min() < 0 or seeds.max() >= adj.rows):
        raise ValueError(f"seed ids outside [0, {adj.rows})")
    visited = np.zeros(adj.rows, dtype=bool)
    visited[seeds] = True
    frontier = seeds
    for _ in range(hops):
        nxt = []
        for u in frontier:
            nbrs = adj.indices[adj.indptr[u] : adj.indptr[u + 1]]
            if fanout is not None and len(nbrs) > fanout:
                nbrs = rng.choice(nbrs, size=fanout, replace=False)
            nxt.append(nbrs)
        if not nxt:
            break
        cand = np.unique(np.concatenate(nxt).astype(np.int64))
        frontier = cand[~visited[cand]]
        visited[frontier] = True
        if frontier.size == 0:
            break
    return np.flatnonzero(visited).astype(np.int64)


def induced_subgraph(adj: CSRMatrix, nodes: np.ndarray) -> CSRMatrix:
    """Extract ``adj[nodes][:, nodes]`` (rows and columns relabelled to
    positions in ``nodes``), preserving stored values."""
    m = adj.to_scipy()
    return CSRMatrix.from_scipy(m[nodes][:, nodes].tocsr())
