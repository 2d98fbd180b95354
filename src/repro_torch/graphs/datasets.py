"""GCN dataset pipeline: seeded synthetic stand-ins for the paper's graphs.

A numpy copy of ``repro.graphs.datasets``; every array equals the
reference's for the same ``seed``.  The five evaluation graphs (Table III
of the paper) are synthesized as community-structured power-law graphs
with the published node/edge/feature-dim statistics.  The adjacency is
returned GCN-normalized: A_hat = D^-1/2 (A + I) D^-1/2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.core.sparse_formats import CSRMatrix


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    nodes: int
    edges: int
    feature_dim: int
    classes: int = 16


# Table III of the paper.
DATASETS: Dict[str, DatasetSpec] = {
    "cora": DatasetSpec("cora", 2_708, 5_429, 1_433, 7),
    "citeseer": DatasetSpec("citeseer", 3_327, 4_732, 3_703, 6),
    "pubmed": DatasetSpec("pubmed", 19_717, 44_338, 500, 3),
    "reddit": DatasetSpec("reddit", 232_965, 11_606_919, 602, 41),
    "yelp": DatasetSpec("yelp", 716_847, 13_954_819, 300, 100),
}


def _power_law_probs(n: int, alpha: float, rng: np.random.Generator,
                     permute: bool = True) -> np.ndarray:
    ranks = rng.permutation(n).astype(np.float64) if permute else np.arange(n, dtype=np.float64)
    p = (ranks + 1.0) ** (-alpha)
    return p / p.sum()


def _community_power_law_edges(
    n: int,
    m: int,
    alpha: float,
    intra_frac: float,
    comm_size: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample m edges from a community-structured power-law model.

    A fraction ``intra_frac`` of edges stays inside a community (sources
    spread over it, destinations on its local hubs); the rest connects
    global power-law endpoints.
    """
    n_comm = max(n // comm_size, 1)
    comm_of = rng.permutation(n) % n_comm          # balanced communities
    order = np.argsort(comm_of, kind="stable")     # nodes grouped by comm
    comm_start = np.searchsorted(comm_of[order], np.arange(n_comm))
    comm_sizes = np.diff(np.append(comm_start, n))

    m_intra = int(m * intra_frac)
    comm_pick = rng.integers(0, n_comm, size=m_intra)
    u = rng.random(m_intra)
    v = rng.random(m_intra)

    def zipf_idx(x: np.ndarray, size: np.ndarray, gamma: float = 3.0) -> np.ndarray:
        # uniform -> concentrated-near-0 index (local hubs at low indices)
        return np.minimum((size * x ** gamma).astype(np.int64), size - 1)

    s_local = np.minimum(
        (comm_sizes[comm_pick] * u).astype(np.int64),
        comm_sizes[comm_pick] - 1,
    )
    d_local = zipf_idx(v, comm_sizes[comm_pick])
    src_i = order[comm_start[comm_pick] + s_local]
    dst_i = order[comm_start[comm_pick] + d_local]

    m_inter = m - m_intra
    p = _power_law_probs(n, alpha, rng)
    dst_g = rng.choice(n, size=m_inter, p=p)
    src_g = rng.integers(0, n, size=m_inter)

    return np.concatenate([src_i, src_g]), np.concatenate([dst_i, dst_g])


def synthesize_adjacency(
    spec: DatasetSpec,
    seed: int = 0,
    alpha: float = 1.8,
    intra_frac: float = 0.88,
    comm_size: Optional[int] = None,
) -> CSRMatrix:
    """Symmetric community power-law adjacency, ~spec.edges undirected edges.

    Sampling tops up until the undirected edge count reaches the Table III
    target, since Zipf concentration collapses duplicates.
    """
    rng = np.random.default_rng(seed)
    avg_deg = 2.0 * spec.edges / spec.nodes
    if comm_size is None:
        comm_size = max(16, int(1.5 * avg_deg))
    acc = sp.csr_matrix((spec.nodes, spec.nodes), dtype=np.float32)
    target = 2 * spec.edges  # symmetric nnz
    m = int(spec.edges * 1.25)
    for _ in range(12):
        src, dst = _community_power_law_edges(
            spec.nodes, m, alpha, intra_frac, comm_size, rng
        )
        keep = src != dst
        src, dst = src[keep], dst[keep]
        a = sp.csr_matrix(
            (np.ones(len(src), np.float32), (src, dst)),
            shape=(spec.nodes, spec.nodes),
        )
        acc = acc + a + a.T
        acc.data[:] = 1.0
        if acc.nnz >= target:
            break
        m = max(int((target - acc.nnz) * 0.75), 1_000)
    acc.setdiag(0)
    acc.eliminate_zeros()
    return CSRMatrix.from_scipy(acc)


def gcn_normalize(adj: CSRMatrix) -> CSRMatrix:
    """A_hat = D^-1/2 (A + I) D^-1/2 (Kipf & Welling)."""
    a = adj.to_scipy().astype(np.float64)
    a = a + sp.eye(a.shape[0], format="csr")
    deg = np.asarray(a.sum(axis=1)).ravel()
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    d = sp.diags(d_inv_sqrt)
    return CSRMatrix.from_scipy((d @ a @ d).tocsr().astype(np.float32))


@dataclasses.dataclass(frozen=True)
class GraphDataset:
    spec: DatasetSpec
    adj: CSRMatrix            # raw symmetric adjacency (no self loops)
    adj_norm: CSRMatrix       # GCN-normalized (with self loops)
    features: np.ndarray      # (nodes, feature_dim) float32
    labels: np.ndarray        # (nodes,) int32


def load_dataset(
    name: str,
    seed: int = 0,
    with_features: bool = True,
    feature_sparsity: float = 0.6,
) -> GraphDataset:
    """Synthesize one of the five evaluation datasets by name.

    Unlike the reference this keeps no process-wide cache: callers hold
    the returned dataset for as long as they need it.
    """
    spec = DATASETS[name]
    adj = synthesize_adjacency(spec, seed=seed)
    adj_norm = gcn_normalize(adj)
    rng = np.random.default_rng(seed + 1)
    if with_features:
        feats = rng.standard_normal((spec.nodes, spec.feature_dim)).astype(
            np.float32
        )
        # Workload-dependent feature sparsity: zero out a fraction of entries.
        mask = rng.random(feats.shape) < feature_sparsity
        feats[mask] = 0.0
    else:
        feats = np.zeros((spec.nodes, 0), np.float32)
    labels = rng.integers(0, spec.classes, spec.nodes).astype(np.int32)
    return GraphDataset(
        spec=spec, adj=adj, adj_norm=adj_norm, features=feats, labels=labels
    )
