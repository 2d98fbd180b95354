"""Graph partitioners for the inter-tile edge-cut (paper Section IV-A).

The port's copy of ``repro.graphs.partition``; for the same adjacency
every permutation equals the reference's, element for element.

* label propagation (``label_propagation_permutation``) — the METIS-like
  edge-cut every simulator figure uses; its sorts and group-bys run as
  ``torch`` ops on the given device (the card unless the caller passes
  ``device="cpu"``), ties broken by input order as the reference's
  stable numpy sorts break them;
* greedy BFS clustering (``cluster_greedy_bfs``) — a serial queue per
  node, so it stays numpy on the host, as ``core.preprocess`` does.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.device import resolve_device


def cluster_greedy_bfs(adj: CSRMatrix, tile: int, seed: int = 0) -> np.ndarray:
    """Return a node permutation grouping BFS-grown clusters of <= tile nodes.

    Seeds are picked by descending degree (supernodes anchor clusters);
    each cluster visits its highest-degree neighbours first.
    """
    n = adj.rows
    deg = adj.row_nnz()
    visited = np.zeros(n, dtype=bool)
    order = []
    seeds = np.argsort(-deg, kind="stable")
    indptr, indices = adj.indptr, adj.indices
    for s in seeds:
        if visited[s]:
            continue
        cluster = []
        q = deque([int(s)])
        visited[s] = True
        while q and len(cluster) < tile:
            u = q.popleft()
            cluster.append(u)
            nbrs = indices[indptr[u] : indptr[u + 1]]
            for v in nbrs[np.argsort(-deg[nbrs], kind="stable")]:
                if not visited[v]:
                    visited[v] = True
                    q.append(int(v))
        # anything left in the queue seeds later clusters
        for v in q:
            visited[v] = False
        order.extend(cluster)
    return np.asarray(order, dtype=np.int64)


def _firsts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Mask of the first element of each run of equal sorted keys."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return first


def label_propagation_permutation(
    adj: CSRMatrix, iters: int = 5, seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """Community detection by label propagation; a node permutation.

    Each iteration every node adopts the most frequent label among its
    neighbours (ties -> smallest label), two O(E log E) sorts per
    iteration on ``device``.  The permutation orders nodes by final label,
    and within a label by descending degree (hubs lead their community),
    ties by node id.  Returned on the host as int64.
    """
    dev = resolve_device(device)
    n = adj.rows
    rnz = torch.as_tensor(adj.row_nnz(), device=dev)
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=dev), rnz)
    dst = torch.as_tensor(adj.indices, device=dev).to(torch.int64)
    e = len(dst)
    labels = torch.arange(n, dtype=torch.int64, device=dev)
    for _ in range(iters):
        # count (src, label) pairs: runs of the sorted keys
        ks = torch.sort(src * n + labels[dst]).values
        starts = torch.nonzero(_firsts(ks)).flatten()
        counts = torch.diff(starts, append=starts.new_tensor([e]))
        run_src = ks[starts] // n
        run_lbl = ks[starts] % n
        del ks, starts
        # per src: the label with the most pairs; runs of one src are in
        # label order, so the stable sort keeps the smallest label first
        sel_key = run_src * (e + 2) + (e + 1 - counts)
        sorder = torch.sort(sel_key, stable=True).indices
        ssrc = run_src[sorder]
        first = _firsts(ssrc)
        new_labels = labels.clone()
        new_labels[ssrc[first]] = run_lbl[sorder][first]
        if torch.equal(new_labels, labels):
            break
        labels = new_labels
    # order by (community, -degree, node id): two stable sorts
    order = torch.sort(-rnz, stable=True).indices
    order = order[torch.sort(labels[order], stable=True).indices]
    return order.cpu().numpy().astype(np.int64)


def edge_cut_quality(adj: CSRMatrix, perm: np.ndarray, tile: int) -> float:
    """Fraction of edges that stay inside a tile after permuting by perm."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    rows = np.repeat(np.arange(adj.rows), adj.row_nnz())
    prows = inv[rows] // tile
    pcols = inv[adj.indices] // tile
    return float((prows == pcols).mean()) if adj.nnz else 1.0
