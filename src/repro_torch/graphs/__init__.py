"""Graph data pipeline: seeded synthetic stand-ins for the paper's
evaluation graphs, partitioning and neighbour sampling."""

from repro_torch.graphs.datasets import DATASETS, DatasetSpec, load_dataset
from repro_torch.graphs.partition import cluster_greedy_bfs, label_propagation_permutation, edge_cut_quality
from repro_torch.graphs.sampling import induced_subgraph, sample_k_hop

__all__ = ["DATASETS", "DatasetSpec", "load_dataset", "cluster_greedy_bfs",
           "label_propagation_permutation", "edge_cut_quality",
           "sample_k_hop", "induced_subgraph"]
