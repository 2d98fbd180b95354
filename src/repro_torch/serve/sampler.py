"""Per-request subgraph extraction for bounded-latency GCN queries.

The port of ``repro.serve.sampler``; for the same graph, seeds and
sampler seed the node sets and the preprocessed operands equal the
reference's.  A request names a handful of seed nodes; answering it needs
only the seeds' ``hops``-hop receptive field.  The sampler expands that
field over the *normalized* adjacency (so the induced operand keeps the
global degree scaling), caps the per-node fanout so supernodes cannot
blow up the request's working set, and re-runs the hybrid preprocessing —
including the intra-tile vertex-cut (Algorithm 1) — on the induced
subgraph, so every extracted operand meets the same ``tau`` bound the
full-graph kernels rely on.  The preprocessed operand goes through the
artifact registry (content-keyed, memory only), so repeated queries over
the same node set skip the vertex-cut.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.graphs.sampling import induced_subgraph, sample_k_hop
from repro_torch.models.gcn import GCNConfig, GCNGraph
from repro_torch.serve.registry import ArtifactRegistry


@dataclasses.dataclass
class SampledSubgraph:
    """One request's extracted, preprocessed operand."""

    nodes: np.ndarray        # (n_sub,) global node ids, sorted
    seed_local: np.ndarray   # (n_seeds,) positions of the seeds in ``nodes``
    sub_adj: CSRMatrix       # induced normalized adjacency (local ids)
    graph: GCNGraph          # vertex-cut ELL operand for the subgraph

    @property
    def n_sub_nodes(self) -> int:
        return int(self.nodes.size)

    @property
    def n_ell_rows(self) -> int:
        return int(self.graph.pre.ell.padded_rows)


class SubgraphSampler:
    """k-hop, fanout-capped extractor bound to one graph + config."""

    def __init__(
        self,
        adj_norm: CSRMatrix,
        cfg: GCNConfig,
        *,
        hops: Optional[int] = None,
        fanout: Optional[int] = 32,
        seed: int = 0,
        registry: Optional[ArtifactRegistry] = None,
    ):
        self.adj_norm = adj_norm
        self.cfg = cfg
        self.hops = cfg.n_layers if hops is None else hops
        self.fanout = fanout
        self.registry = registry or ArtifactRegistry()
        self.seed = seed

    def sample_nodes(self, seeds: Sequence[int]) -> np.ndarray:
        """The request's receptive field, sorted global node ids: the node
        set :meth:`extract` preprocesses."""
        if len(seeds) == 0:
            raise ValueError("a query needs at least one seed node")
        # Fanout sampling is keyed on the request contents, not shared
        # sampler state: identical seed sets draw identical neighbor
        # subsets, so their subgraphs content-hash to the same registry
        # entry and repeated queries skip the vertex-cut.
        rng = np.random.default_rng(
            [self.seed] + sorted(int(s) for s in np.unique(np.asarray(seeds)))
        )
        return sample_k_hop(
            self.adj_norm, seeds, self.hops, fanout=self.fanout, rng=rng
        )

    def extract(self, seeds: Sequence[int]) -> SampledSubgraph:
        nodes = self.sample_nodes(seeds)
        # Positions of the seeds in ``nodes``, preserving request order.
        seed_local = np.searchsorted(nodes, np.asarray(seeds, dtype=np.int64))
        sub_adj = induced_subgraph(self.adj_norm, nodes)
        graph = self.registry.get_or_build(sub_adj, self.cfg, persist=False)
        return SampledSubgraph(
            nodes=nodes,
            seed_local=seed_local.astype(np.int64),
            sub_adj=sub_adj,
            graph=graph,
        )
