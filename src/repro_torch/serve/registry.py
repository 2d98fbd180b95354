"""Artifact registry: content-keyed preprocessed operands + forward steps.

The port of ``repro.serve.registry``.  The hybrid preprocessing pipeline
(edge-cut + Algorithm 1 vertex-cut) is the expensive, request-independent
half of GCN serving.  The registry keys ``(adjacency contents,
preprocessing-relevant GCNConfig fields)`` to the preprocessed
:class:`~repro_torch.models.gcn.GCNGraph`, so that cost is paid once per
graph, not once per request:

* an in-memory LRU holds hot artifacts (full graphs *and* sampled
  subgraphs — repeated queries over the same node set skip the vertex-cut
  entirely);
* full-graph artifacts are also pickled to disk (``serve.cache``) so they
  survive process restarts, under the cache directory's ``repro_torch``
  subdirectory: :func:`graph_key` is the reference's key, and the
  reference's pickles of the same graph sit one level up.

Full-graph forward steps are closures over ``gcn_forward`` and the
registered operand, cached per key in memory only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse_formats import CSRMatrix
from repro_torch.device import resolve_device
from repro_torch.models.gcn import GCNConfig, GCNGraph, gcn_forward
from repro_torch.serve import cache as disk_cache

_KEY_VERSION = "v1"


@dataclasses.dataclass
class RegistryStats:
    """Counters proving where each artifact came from."""

    mem_hits: int = 0
    disk_hits: int = 0
    builds: int = 0          # preprocessing actually ran


def graph_key(adj: CSRMatrix, cfg: GCNConfig) -> str:
    """Content hash over the adjacency and the preprocessing-relevant
    config fields (dims/impl don't change the preprocessed operand); the
    same string as the reference's for the same graph and fields."""
    h = hashlib.sha256()
    h.update(_KEY_VERSION.encode())
    h.update(np.ascontiguousarray(adj.indptr).tobytes())
    h.update(np.ascontiguousarray(adj.indices).tobytes())
    h.update(np.ascontiguousarray(adj.data).tobytes())
    meta = (adj.shape, cfg.tau, cfg.tile_rows, cfg.edge_cut, cfg.block_rows)
    h.update(repr(meta).encode())
    return f"gcngraph_{h.hexdigest()[:24]}"


class ArtifactRegistry:
    """LRU + disk registry of preprocessed graphs and forward steps."""

    def __init__(self, cache_dir: Optional[str] = None, mem_capacity: int = 512):
        self.cache_dir = cache_dir or disk_cache.default_cache_dir()
        # the port's own pickles, apart from the reference's
        self.disk_dir = os.path.join(self.cache_dir, disk_cache.NAMESPACE)
        self.mem_capacity = mem_capacity
        self.stats = RegistryStats()
        # A step closes over its operand; when the LRU drops the graph,
        # keeping the step would pin the memory the eviction was supposed
        # to release, so eviction cascades into _forwards.
        self._graphs = disk_cache.LruDict(
            mem_capacity, on_evict=self._drop_forwards)
        self._forwards: Dict[Tuple, Callable] = {}

    def get_or_build(
        self,
        adj: CSRMatrix,
        cfg: GCNConfig,
        persist: bool = True,
        key: Optional[str] = None,
    ) -> GCNGraph:
        """Return the preprocessed graph for ``(adj, cfg)``, building it at
        most once per content key (``persist`` keeps full graphs on disk;
        sampled subgraphs stay memory-only).  ``key`` lets callers that
        already hashed the adjacency skip a second content pass."""
        if key is None:
            key = graph_key(adj, cfg)
        graph = self._graphs.get(key)
        if graph is not None:
            self.stats.mem_hits += 1
            return graph
        if persist:
            graph, hit = disk_cache.load_pickle(key, self.disk_dir)
            if hit:
                self.stats.disk_hits += 1
                self._graphs.put(key, graph)
                return graph
        graph = GCNGraph.build(adj, cfg)
        self.stats.builds += 1
        if persist:
            disk_cache.store_pickle(key, graph, self.disk_dir)
        self._graphs.put(key, graph)
        return graph

    def forward_step(
        self, adj: CSRMatrix, cfg: GCNConfig, persist: bool = True,
        plan=None, precision: str = "f32", device=None, device_model=None,
    ) -> Callable:
        """Full-graph forward ``step(params, features) -> logits`` (a
        tensor on ``device``, the card unless given) bound to the
        registered preprocessed operand.

        Keyed on ``(graph_key, cfg, precision, plan, device,
        device_model)``: graph_key deliberately ignores forward-only fields
        (dims, spmm impl/blocks) so the *operand* is shared, but the step
        is not.  ``plan`` is ``None`` (the config's static plan), a frozen
        plan object (keyed by equality) or ``"auto"``, which plans the
        whole stack through ``exec.pipeline`` on ``device_model`` (the
        H100 kernel model when None) once, here, so every call runs the
        chosen per-layer plans.
        """
        dev = resolve_device(device)
        gkey = graph_key(adj, cfg)
        key = (gkey, cfg, precision, plan, dev, device_model)
        fwd = self._forwards.get(key)
        if fwd is not None:
            return fwd
        graph = self.get_or_build(adj, cfg, persist=persist, key=gkey)
        step_plan = plan
        if isinstance(plan, str):
            if plan != "auto":
                raise ValueError(f"unknown plan: {plan!r} (expected 'auto')")
            from repro_torch.exec.pipeline import plan_pipeline

            step_plan = plan_pipeline(cfg, graph.pre.ell, precision=precision,
                                      device=device_model)

        def fwd(params, feats) -> torch.Tensor:
            return gcn_forward(params, graph, feats, cfg, plan=step_plan,
                               precision=precision, device=dev)

        self._forwards[key] = fwd
        return fwd

    def quantized_ell(
        self, adj: CSRMatrix, cfg: GCNConfig, precision: str,
        persist: bool = True,
    ):
        """The graph's :class:`~repro_torch.exec.quant.QuantizedELL`
        artifact, content-keyed by graph + precision + scale granularity.

        It rides the same memory LRU + disk pickle machinery as the graphs
        (the stats counters cover it too).  ``precision`` must be non-f32
        — the f32 artifact *is* the preprocessed TiledELL.
        """
        from repro_torch.exec import quant

        gkey = graph_key(adj, cfg)
        qkey = f"{gkey}_q_{precision}_{cfg.block_rows}"
        art = self._graphs.get(qkey)
        if art is not None:
            self.stats.mem_hits += 1
            return art
        if persist:
            art, hit = disk_cache.load_pickle(qkey, self.disk_dir)
            if hit:
                self.stats.disk_hits += 1
                self._graphs.put(qkey, art)
                return art
        graph = self.get_or_build(adj, cfg, persist=persist, key=gkey)
        art = quant.quantize_ell(graph.pre.ell, precision, cfg.block_rows)
        self.stats.builds += 1
        if persist:
            disk_cache.store_pickle(qkey, art, self.disk_dir)
        self._graphs.put(qkey, art)
        return art

    def _drop_forwards(self, key: str, _graph) -> None:
        for fkey in [k for k in self._forwards if k[0] == key]:
            del self._forwards[fkey]
