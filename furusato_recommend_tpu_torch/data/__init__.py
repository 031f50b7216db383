from .dataset import Dataset, load_text_dataset, synthetic_dataset
from .graph import CSR, BipartiteGraph, COOEdges, build_bipartite_graph

__all__ = [
    "Dataset",
    "load_text_dataset",
    "synthetic_dataset",
    "CSR",
    "COOEdges",
    "BipartiteGraph",
    "build_bipartite_graph",
]
