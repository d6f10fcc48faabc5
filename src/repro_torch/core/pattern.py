"""Pattern codes (paper §3.2; counterpart of ``repro.core.pattern``).

An embedding's subgraph is packed into an int32 code: vertex labels in the
high digits (label-major), upper-triangle adjacency bits in the low bits,
so minimising the code over vertex permutations is a lexicographic
(labels, adjacency) minimisation.  The arithmetic is int32 and wraps as
JAX's does, because FSM's codes are an output both packages must agree on.

Three tiers, as in the paper: the generic canonical labeling (minimum code
over all k! permutations), quick patterns (the identity-order code, grouped
before canonicalising one representative per group), and the customised
O(1) 3-/4-motif classifiers with the memoised level transition (§4.2).

Pattern-ID enums for motifs:
  3-motifs: 0 = wedge (path), 1 = triangle
  4-motifs: 0 = 3-path, 1 = 3-star, 2 = 4-cycle, 3 = tailed-triangle,
            4 = diamond, 5 = 4-clique
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

WEDGE, TRIANGLE = 0, 1
PATH4, STAR4, CYCLE4, TAILED4, DIAMOND4, CLIQUE4 = 0, 1, 2, 3, 4, 5
N_MOTIFS = {3: 2, 4: 6}
MOTIF_NAMES = {
    3: ["wedge", "triangle"],
    4: ["3-path", "3-star", "4-cycle", "tailed-triangle", "diamond",
        "4-clique"],
}
INT_MAX = (1 << 31) - 1


def _tri_bit(i: int, j: int, k: int) -> int:
    """Bit position for pair (i < j) in the upper-triangle packing."""
    assert i < j
    return sum(k - 1 - r for r in range(i)) + (j - i - 1)


def _wrap_int32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def pack_code(adj: torch.Tensor, labels: Optional[torch.Tensor], k: int,
              n_labels: int = 1,
              perm: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Pack adjacency (+labels) of a k-vertex subgraph into an int32 code.

    adj: bool[..., k, k]; labels: int[..., k] or None.  With ``perm`` the
    code is that of the vertices taken in the order ``perm`` (JAX's
    ``pack_code(adj[..., perm, :][..., :, perm], labels[..., perm])``),
    read without copying the permuted matrices.
    """
    p = range(k) if perm is None else perm
    n_pairs = k * (k - 1) // 2
    code = torch.zeros(adj.shape[:-2], dtype=torch.int32, device=adj.device)
    for i in range(k):
        for j in range(i + 1, k):
            bit = adj[..., p[i], p[j]].to(torch.int32) << _tri_bit(i, j, k)
            code = code | bit
    if labels is not None and n_labels > 1:
        mult = 1 << n_pairs
        for i in range(k - 1, -1, -1):
            code = code + labels[..., p[i]].to(torch.int32) * _wrap_int32(mult)
            mult = _wrap_int32(mult * n_labels)
    return code


def canonical_code(adj: torch.Tensor, labels: Optional[torch.Tensor], k: int,
                   n_labels: int = 1) -> torch.Tensor:
    """Minimum packed code over all k! permutations (the exact canonical
    form)."""
    best = None
    for perm in itertools.permutations(range(k)):
        code = pack_code(adj, labels, k, n_labels, perm=perm)
        best = code if best is None else torch.minimum(best, code)
    return best


def quick_code(adj: torch.Tensor, labels: Optional[torch.Tensor], k: int,
               n_labels: int = 1) -> torch.Tensor:
    """Identity-order code (the paper's quick pattern)."""
    return pack_code(adj, labels, k, n_labels)


def unique_fixed(codes: torch.Tensor, size: int, fill: int = INT_MAX):
    """``jnp.unique(codes, size=size, fill_value=fill,
    return_inverse=True)`` with static shapes and no host read: the
    ``size`` smallest distinct codes (padded with ``fill``), and each
    code's rank among all distinct codes (``size`` or more for a code past
    a truncated table)."""
    dev = codes.device
    sorted_c, order = torch.sort(codes)
    first = torch.ones(sorted_c.shape, dtype=torch.bool, device=dev)
    first[1:] = sorted_c[1:] != sorted_c[:-1]
    rank = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    inverse = torch.empty_like(rank).scatter_(0, order, rank)
    uniq = torch.full((size + 1,), fill, dtype=codes.dtype, device=dev)
    dest = torch.where(first & (rank < size), rank, size).long()
    uniq.index_put_((dest,), sorted_c)     # slot ``size`` takes the rest
    return uniq[:size], inverse


def canonicalize_via_quick(adj: torch.Tensor, labels: Optional[torch.Tensor],
                           k: int, n_labels: int, max_unique: int
                           ) -> torch.Tensor:
    """Reduce by quick pattern, then canonicalise one representative per
    group (§3.2).  Returns the canonical code per embedding; ``max_unique``
    bounds the distinct quick patterns (static), as in JAX, whose
    representative of a group is its first row."""
    qc = quick_code(adj, labels, k, n_labels)
    _, inv = unique_fixed(qc, max_unique, fill=-1)
    n = qc.shape[0]
    inv = inv.clamp(max=max_unique - 1).long()
    first = torch.full((max_unique,), n, dtype=torch.int64, device=qc.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=qc.device),
                          reduce="amin")
    first = first.clamp(0, max(n - 1, 0))
    rep_lab = None if labels is None else labels[first]
    rep_canon = canonical_code(adj[first], rep_lab, k, n_labels)
    return rep_canon[inv]


# ---------------------------------------------------------------------------
# Customised motif classification (paper §4.2)


def classify_3motif(adj: torch.Tensor) -> torch.Tensor:
    """Listing 6: 3 edges -> triangle else wedge.  adj: bool[..., 3, 3]."""
    n_edges = (adj[..., 0, 1].to(torch.int32) + adj[..., 0, 2].to(torch.int32)
               + adj[..., 1, 2].to(torch.int32))
    return torch.where(n_edges == 3, TRIANGLE, WEDGE).to(torch.int32)


def classify_4motif(adj: torch.Tensor) -> torch.Tensor:
    """O(1) 4-motif classifier from (edge count, max degree): 3 edges, star
    iff max degree 3 else path; 4 edges, tailed iff max degree 3 else cycle;
    5 edges diamond; 6 edges clique."""
    deg = adj.to(torch.int32).sum(dim=-1)
    n_edges = deg.sum(dim=-1) // 2
    max_deg = deg.max(dim=-1).values
    out = torch.where(
        n_edges == 6, CLIQUE4,
        torch.where(n_edges == 5, DIAMOND4,
                    torch.where(n_edges == 4,
                                torch.where(max_deg == 3, TAILED4, CYCLE4),
                                torch.where(max_deg == 3, STAR4, PATH4))))
    return out.to(torch.int32)


def classify_4motif_memoized(prev_pat: torch.Tensor, center: torch.Tensor,
                             conn: torch.Tensor) -> torch.Tensor:
    """Fig. 6 memoisation: the 4-motif from the 3-motif of the first three
    vertices, the wedge's centre position (0..2, unused for triangles) and
    ``conn`` (bool[N, 3]: is the new vertex adjacent to position p)."""
    c = conn.to(torch.int32)
    n_conn = c.sum(dim=-1)
    hits_center = torch.gather(c, 1, center[:, None].long())[:, 0].bool()
    from_tri = torch.where(n_conn == 3, CLIQUE4,
                           torch.where(n_conn == 2, DIAMOND4, TAILED4))
    wedge2 = torch.where(hits_center, TAILED4, CYCLE4)
    from_wedge = torch.where(
        n_conn == 3, DIAMOND4,
        torch.where(n_conn == 2, wedge2,
                    torch.where(hits_center, STAR4, PATH4)))
    return torch.where(prev_pat == TRIANGLE, from_tri,
                       from_wedge).to(torch.int32)


def wedge_center(adj3: torch.Tensor) -> torch.Tensor:
    """Position (0..2) of the degree-2 vertex of a wedge.  adj3:
    bool[..., 3, 3]."""
    deg = adj3.to(torch.int32).sum(dim=-1)
    return torch.argmax(deg, dim=-1).to(torch.int32)


def motif_canonical_codes(k: int) -> dict[int, int]:
    """Motif enum -> canonical code, from reference adjacency."""
    if k == 3:
        mats = {WEDGE: [(0, 1), (1, 2)], TRIANGLE: [(0, 1), (1, 2), (0, 2)]}
    else:
        mats = {PATH4: [(0, 1), (1, 2), (2, 3)],
                STAR4: [(0, 1), (0, 2), (0, 3)],
                CYCLE4: [(0, 1), (1, 2), (2, 3), (0, 3)],
                TAILED4: [(0, 1), (1, 2), (0, 2), (2, 3)],
                DIAMOND4: [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3)],
                CLIQUE4: [(i, j) for i in range(4) for j in range(i + 1, 4)]}
    out = {}
    for pid, edges in mats.items():
        adj = np.zeros((k, k), bool)
        for i, j in edges:
            adj[i, j] = adj[j, i] = True
        out[pid] = int(canonical_code(torch.from_numpy(adj)[None], None,
                                      k)[0])
    return out
