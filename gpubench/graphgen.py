"""The benchmark's own graphs: a frozen copy of the port's generator.

``synthesize`` and ``gcn_normalize`` copy ``_power_law_probs``,
``_community_power_law_edges``, ``synthesize_adjacency`` and
``gcn_normalize`` of ``repro_torch/graphs/datasets.py`` as they stood
when the benchmark was written, so a change to the program cannot change
the benchmark's data.  The arrays equal the program's for the same
parameters (``gpubench/tests/test_gpubench_parts.py`` holds them equal).

A normalized graph is cached on disk under ``<cache>/graphs/`` by its
parameters and :data:`GENERATOR_VERSION`, so only the first run of a
configuration in a checkout synthesizes it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Tuple

import numpy as np
import scipy.sparse as sp

#: Bump when the arrays :func:`load_or_make` returns change.
GENERATOR_VERSION = 1

Csr = Tuple[np.ndarray, np.ndarray, np.ndarray]   # indptr, indices, data


def _power_law_probs(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    ranks = rng.permutation(n).astype(np.float64)
    p = (ranks + 1.0) ** (-alpha)
    return p / p.sum()


def _community_power_law_edges(n: int, m: int, alpha: float, intra_frac: float,
                               comm_size: int, rng: np.random.Generator):
    """``m`` edges: ``intra_frac`` of them inside balanced communities
    (sources spread over one, destinations on its local hubs), the rest
    between global power-law endpoints."""
    n_comm = max(n // comm_size, 1)
    comm_of = rng.permutation(n) % n_comm
    order = np.argsort(comm_of, kind="stable")
    comm_start = np.searchsorted(comm_of[order], np.arange(n_comm))
    comm_sizes = np.diff(np.append(comm_start, n))

    m_intra = int(m * intra_frac)
    comm_pick = rng.integers(0, n_comm, size=m_intra)
    u = rng.random(m_intra)
    v = rng.random(m_intra)
    size = comm_sizes[comm_pick]
    s_local = np.minimum((size * u).astype(np.int64), size - 1)
    d_local = np.minimum((size * v ** 3.0).astype(np.int64), size - 1)
    src_i = order[comm_start[comm_pick] + s_local]
    dst_i = order[comm_start[comm_pick] + d_local]

    m_inter = m - m_intra
    p = _power_law_probs(n, alpha, rng)
    dst_g = rng.choice(n, size=m_inter, p=p)
    src_g = rng.integers(0, n, size=m_inter)
    return np.concatenate([src_i, src_g]), np.concatenate([dst_i, dst_g])


def synthesize(nodes: int, edges: int, seed: int, alpha: float = 1.8,
               intra_frac: float = 0.88) -> sp.csr_matrix:
    """Symmetric 0/1 adjacency without self loops, topped up until it
    holds ``2 * edges`` entries (duplicates collapse)."""
    rng = np.random.default_rng(seed)
    avg_deg = 2.0 * edges / nodes
    comm_size = max(16, int(1.5 * avg_deg))
    acc = sp.csr_matrix((nodes, nodes), dtype=np.float32)
    target = 2 * edges
    m = int(edges * 1.25)
    for _ in range(12):
        src, dst = _community_power_law_edges(nodes, m, alpha, intra_frac,
                                              comm_size, rng)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        a = sp.csr_matrix((np.ones(len(src), np.float32), (src, dst)),
                          shape=(nodes, nodes))
        acc = acc + a + a.T
        acc.data[:] = 1.0
        if acc.nnz >= target:
            break
        m = max(int((target - acc.nnz) * 0.75), 1_000)
    acc.setdiag(0)
    acc.eliminate_zeros()
    return acc


def gcn_normalize(adj: sp.csr_matrix) -> Csr:
    """A_hat = D^-1/2 (A + I) D^-1/2 as sorted CSR arrays (int64 indptr,
    int32 indices, f32 data)."""
    a = adj.astype(np.float64) + sp.eye(adj.shape[0], format="csr")
    deg = np.asarray(a.sum(axis=1)).ravel()
    d = sp.diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
    m = sp.csr_matrix((d @ a @ d).tocsr().astype(np.float32))
    m.sort_indices()
    return (m.indptr.astype(np.int64), m.indices.astype(np.int32),
            np.asarray(m.data))


def graph_name(graph: dict) -> str:
    """The cache entry of a configuration's ``graph`` block."""
    return (f"{graph['dataset']}-n{graph['nodes']}-e{graph['edges']}"
            f"-s{graph['seed']}-a{graph['alpha']}-i{graph['intra_frac']}"
            f"-v{GENERATOR_VERSION}")


def load_or_make(graph: dict, cache_dir: str) -> Tuple[Csr, bool]:
    """The normalized CSR of a configuration's ``graph`` block and whether
    it was read from ``cache_dir`` (else synthesized and stored there)."""
    where = os.path.join(cache_dir, "graphs", graph_name(graph))
    names = ("indptr", "indices", "data")
    if os.path.isdir(where):
        return tuple(np.load(os.path.join(where, f"{n}.npy"))
                     for n in names), True
    csr = gcn_normalize(synthesize(graph["nodes"], graph["edges"],
                                   graph["seed"], graph["alpha"],
                                   graph["intra_frac"]))
    os.makedirs(os.path.dirname(where), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(where))
    try:
        for n, a in zip(names, csr):
            np.save(os.path.join(tmp, f"{n}.npy"), a)
        try:
            os.rename(tmp, where)
        except OSError:
            if not os.path.isdir(where):   # another run stored it first
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return csr, False
