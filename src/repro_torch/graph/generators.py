"""Deterministic graph generators (counterpart of ``repro.graph.generators``).

The edge lists are drawn with numpy exactly as the JAX package draws them,
so the same seed gives the identical graph in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import DeviceSpec
from repro_torch.graph.csr import CSRGraph, from_edge_list


def erdos_renyi(n: int, p: float, seed: int = 0, labels: int | None = None,
                device: DeviceSpec = None) -> CSRGraph:
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    mask = rng.random(iu[0].shape[0]) < p
    edges = np.stack([iu[0][mask], iu[1][mask]], axis=1)
    lab = rng.integers(0, labels, size=n) if labels else None
    return from_edge_list(edges, n_vertices=n, labels=lab, device=device)


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         labels: int | None = None, device: DeviceSpec = None) -> CSRGraph:
    """RMAT power-law generator (Graph500-style parameters)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << level
        dst |= go_right.astype(np.int64) << level
    edges = np.stack([src, dst], axis=1)
    lab = rng.integers(0, labels, size=n) if labels else None
    return from_edge_list(edges, n_vertices=n, labels=lab, device=device)


def clique(n: int, device: DeviceSpec = None) -> CSRGraph:
    iu = np.triu_indices(n, k=1)
    return from_edge_list(np.stack(iu, axis=1), n_vertices=n, device=device)


def paper_fig2_graph(device: DeviceSpec = None) -> CSRGraph:
    """The labeled 5-vertex example graph of the paper's Fig. 2."""
    edges = [(0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (2, 4), (3, 4)]
    labels = np.array([0, 0, 1, 1, 2], dtype=np.int64)
    return from_edge_list(edges, n_vertices=5, labels=labels, device=device)
