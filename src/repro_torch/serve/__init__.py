"""repro_torch.serve — batched GCN inference serving on the FlexVector SpMM core.

Registry (preprocess once per graph) -> sampler (bounded per-request
receptive fields, vertex-cut re-applied) -> micro-batcher (shape buckets,
one CUDA graph per (bucket, batch), none built after warmup) -> engine
(scenarios + latency reporting).  The port of ``repro.serve``.
"""

from repro_torch.serve.batcher import Bucket, BucketLadder, MicroBatcher, PaddedRequest
from repro_torch.serve.engine import LatencyReport, ServeEngine, latency_report
from repro_torch.serve.registry import ArtifactRegistry, RegistryStats, graph_key
from repro_torch.serve.sampler import SampledSubgraph, SubgraphSampler

__all__ = [
    "ArtifactRegistry",
    "RegistryStats",
    "graph_key",
    "SampledSubgraph",
    "SubgraphSampler",
    "Bucket",
    "BucketLadder",
    "MicroBatcher",
    "PaddedRequest",
    "LatencyReport",
    "latency_report",
    "ServeEngine",
]
