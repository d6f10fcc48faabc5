"""DAG orientation (paper §4.1; counterpart of ``repro.graph.dag``).

Keeps only edges that point "up" a total order on vertices: by degree
(toward the higher-degree endpoint, ties toward the larger id) or by id.
Each k-clique is then enumerated exactly once.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr


def _rank(g: CSRGraph, order: str) -> np.ndarray:
    """Total-order rank per vertex; edge u->v kept iff rank[u] < rank[v]."""
    n = g.n_vertices
    if order == "id":
        return np.arange(n, dtype=np.int64)
    if order == "degree":
        deg = g.degrees().cpu().numpy().astype(np.int64)
        return deg * np.int64(n) + np.arange(n, dtype=np.int64)
    raise ValueError(f"unknown orientation order: {order}")


def orient_dag(g: CSRGraph, order: str = "degree") -> CSRGraph:
    """The DAG-oriented graph (directed CSR, neighbour lists sorted), on
    the input graph's device."""
    rank = _rank(g, order)
    src, dst = (t.cpu().numpy() for t in g.edge_list())
    keep = rank[src] < rank[dst]
    labels = None if g.labels is None else g.labels.cpu().numpy()
    return build_csr(g.n_vertices, src[keep], dst[keep], labels=labels,
                     device=g.device)
