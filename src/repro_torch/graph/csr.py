"""Compressed-sparse-row graph storage on torch tensors (counterpart of
``repro.graph.csr``).

Neighbour lists are sorted ascending, as the paper keeps them (§6.1), which
is what makes the binary-search connectivity check possible.  Building the
CSR is host-side numpy preprocessing; the result lives on one device as
int32 tensors, as is the bit-packed adjacency (``PackedGraph``: full,
partial and core packs) and the degree relabeling that makes a core pack
pay off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable CSR graph on one device.  Neighbour lists sorted ascending.

    Attributes:
      row_ptr: int32[n_vertices + 1]
      col_idx: int32[n_edges]   (directed count; symmetric graphs store
                                 both directions)
      labels:  int32[n_vertices] or None
      n_vertices / n_edges: python ints
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    n_vertices: int
    n_edges: int
    labels: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def to(self, device: DeviceSpec) -> "CSRGraph":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(dev), col_idx=self.col_idx.to(dev),
            labels=None if self.labels is None else self.labels.to(dev))

    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @property
    def max_degree(self) -> int:
        if not self.n_vertices:
            return 0
        return int(self.degrees().max().item())

    def edge_list(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) int32 tensors of all directed edges in CSR order."""
        deg = self.degrees().cpu().numpy()
        src = np.repeat(np.arange(self.n_vertices, dtype=np.int32), deg)
        return torch.from_numpy(src).to(self.device), self.col_idx

    def undirected_edge_list(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) with src < dst: each undirected edge once."""
        src, dst = self.edge_list()
        keep = src < dst
        return src[keep], dst[keep]


@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """Bit-packed adjacency rows for O(1) connectivity probes.

    ``words[r, w]`` holds bits ``32*w .. 32*w+31`` of packed row r as an
    int32 bit pattern (the JAX package stores u32; torch's uint32 lacks
    shift and bitwise kernels on the CPU, and ``(w >> b) & 1`` reads bit 31
    correctly from the int32 pattern).  ``row_slot[v]`` is vertex v's row
    in ``words``, or -1 when v is not packed and a probe must search the
    CSR.  ``n_cols`` is the column coverage: a row answers only for
    neighbour ids below it.

    Three packs, as in the JAX package: the *full* pack (every row and
    column; ``row_slot`` the identity, ``full`` True); the *partial* pack
    of the highest-degree rows that fit the budget, every column covered;
    and the square *core* pack of rows and columns ``[0, c)``, meant for a
    degree-relabeled graph, whose prefix is its high-degree core.
    """

    words: torch.Tensor        # int32[n_packed, n_words]
    row_slot: torch.Tensor     # int32[n_vertices], -1 = not packed
    n_words: int               # ceil(n_cols / 32)
    full: bool                 # every row and every column packed
    n_cols: int                # columns each row covers

    @property
    def n_packed(self) -> int:
        return int(self.words.shape[0])


def core_size(n_vertices: int, max_bytes: int) -> int:
    """Largest c <= n_vertices with ``c * ceil(c/32) * 4 <= max_bytes``:
    the side of the square core pack, about ``sqrt(8 * max_bytes)``."""
    if n_vertices <= 0 or max_bytes <= 0:
        return 0
    c = min(int((max(max_bytes, 1) * 8) ** 0.5) + 32, n_vertices)
    while c > 0 and c * (-(-c // 32)) * 4 > max_bytes:
        c -= 1
    return c


def pack_adjacency(g: CSRGraph, max_bytes: int = 4 << 20,
                   core: bool = False) -> Optional[PackedGraph]:
    """The bit-packed adjacency of ``g`` under a budget of ``max_bytes``,
    built on the host (the rows and slots of the JAX package's
    ``pack_adjacency``, bit for bit).

    The full pack when every row fits; otherwise the partial pack of the
    highest-degree rows that fit (ties to the smaller id), or with
    ``core=True`` the square core pack of rows and columns ``[0, c)``
    (:func:`core_size`).  None for an empty graph, or when not one row
    (or no core) fits.  The words are set by one scatter over the packed
    rows' edges, not row by row.
    """
    n = g.n_vertices
    if n == 0:
        return None
    n_words = -(-n // 32)
    budget_rows = max_bytes // max(n_words * 4, 1)
    rp = g.row_ptr.cpu().numpy().astype(np.int64)
    ci = g.col_idx.cpu().numpy().astype(np.int64)
    deg = rp[1:] - rp[:-1]
    n_cols = n
    full = budget_rows >= n
    if full:
        rows = np.arange(n, dtype=np.int64)
    elif core:
        n_cols = core_size(n, max_bytes)
        if n_cols < 1:
            return None
        rows = np.arange(n_cols, dtype=np.int64)
        n_words = -(-n_cols // 32)
    elif budget_rows < 1:
        return None
    else:
        # degree-major, id-minor: the highest-degree rows answer the most
        # probes per packed byte
        order = np.lexsort((np.arange(n), -deg))
        rows = np.sort(order[:int(budget_rows)]).astype(np.int64)
    row_slot = np.full(n, -1, dtype=np.int64)
    row_slot[rows] = np.arange(rows.shape[0], dtype=np.int64)
    slot = np.repeat(row_slot, deg)
    keep = (slot >= 0) & (ci < n_cols)
    slot, col = slot[keep], ci[keep]
    words = np.zeros(rows.shape[0] * n_words, dtype=np.uint32)
    np.bitwise_or.at(words, slot * n_words + (col >> 5),
                     np.uint32(1) << (col & 31).astype(np.uint32))
    words = words.view(np.int32).reshape(rows.shape[0], n_words)
    dev = g.device
    return PackedGraph(
        words=torch.from_numpy(words.copy()).to(dev),
        row_slot=torch.from_numpy(row_slot.astype(np.int32)).to(dev),
        n_words=int(n_words), full=bool(full),
        n_cols=int(n_cols))


def packed_contains(pg: PackedGraph, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Bitmap membership: is v in N(u)?  Answers only for a packed row of
    u and v below ``n_cols``; anything else (padding such as -1, an
    unpacked row, a column past a core pack) is False, and the caller
    falls back to the CSR."""
    n_vertices = pg.row_slot.shape[0]
    slot = pg.row_slot[u.clamp(0, n_vertices - 1).long()]
    v_c = v.clamp(0, pg.n_cols - 1)
    word = pg.words[slot.clamp(0, pg.words.shape[0] - 1).long(),
                    (v_c >> 5).long()]
    bit = (word >> (v_c & 31)) & 1
    return ((bit == 1) & (slot >= 0) & (u >= 0) & (v >= 0)
            & (u < n_vertices) & (v < pg.n_cols))


def pack_hit_rate(g: CSRGraph, pg: Optional[PackedGraph]) -> float:
    """Degree-weighted probability that a connectivity probe answers from
    the bitmap: P(row packed) * P(column covered), both endpoints drawn in
    proportion to degree (the distribution mining frontiers induce).  1.0
    for a full pack, 0.0 with none; the same float as the JAX package's."""
    if pg is None or g.n_vertices == 0 or g.n_edges == 0:
        return 0.0
    deg = g.degrees().cpu().numpy().astype(np.float64)
    tot = float(deg.sum())
    if tot <= 0:
        return 0.0
    slot = pg.row_slot.cpu().numpy()
    p_row = float(deg[slot >= 0].sum()) / tot
    p_col = float(deg[:pg.n_cols].sum()) / tot
    return p_row * p_col


@dataclasses.dataclass(frozen=True)
class Relabeling:
    """A vertex-relabeled copy of a graph and both id maps:
    ``perm[old_id] = new_id``, ``inv[new_id] = old_id``; ``graph`` is the
    relabeled CSR, its labels permuted along.  Counts, pattern maps and FSM
    codes and supports do not change under relabeling; vertex ids (levels,
    domains) map back through ``inv``."""

    graph: CSRGraph
    perm: np.ndarray
    inv: np.ndarray


def relabel(g: CSRGraph, order: str = "degree") -> Relabeling:
    """Relabel vertices on the host (counterpart of ``repro.graph.csr.
    relabel``).  ``order="degree"`` gives ids by descending degree, ties to
    the smaller old id, so the high-degree core becomes the prefix
    ``[0, c)`` that a core pack covers; ``"identity"`` is the no-op.  The
    new graph lives on ``g``'s device."""
    n = g.n_vertices
    rp = g.row_ptr.cpu().numpy().astype(np.int64)
    if order == "degree":
        inv = np.lexsort((np.arange(n), -(rp[1:] - rp[:-1]))).astype(
            np.int64)
    elif order == "identity":
        inv = np.arange(n, dtype=np.int64)
    else:
        raise ValueError(f"relabel order {order!r} not in "
                         "('degree', 'identity')")
    perm = np.empty(n, dtype=np.int64)
    perm[inv] = np.arange(n, dtype=np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), rp[1:] - rp[:-1])
    dst = g.col_idx.cpu().numpy().astype(np.int64)
    labels = None if g.labels is None else g.labels.cpu().numpy()[inv]
    new_g = build_csr(n, perm[src], perm[dst], labels=labels,
                      device=g.device)
    return Relabeling(graph=new_g, perm=perm, inv=inv)


def build_csr(n_vertices: int, src: np.ndarray, dst: np.ndarray,
              labels: Optional[np.ndarray] = None,
              device: DeviceSpec = None) -> CSRGraph:
    """CSR graph from directed edge arrays (already deduplicated)."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n_vertices)
    row_ptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    lab = None
    if labels is not None:
        lab = torch.from_numpy(np.array(labels, dtype=np.int32)).to(dev)
    return CSRGraph(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(dev),
        col_idx=torch.from_numpy(dst.astype(np.int32)).to(dev),
        n_vertices=int(n_vertices), n_edges=int(dst.shape[0]), labels=lab)


def from_edge_list(edges, n_vertices: Optional[int] = None,
                   labels: Optional[np.ndarray] = None,
                   symmetrize: bool = True,
                   device: DeviceSpec = None) -> CSRGraph:
    """Loop-free, deduplicated CSR graph from (u, v) pairs, symmetric
    unless ``symmetrize=False`` (then each pair is one directed edge)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    u, v = edges[:, 0], edges[:, 1]
    keep = u != v
    u, v = u[keep], v[keep]
    if symmetrize:
        uu = np.concatenate([u, v])
        vv = np.concatenate([v, u])
    else:
        uu, vv = u, v
    if n_vertices is None:
        n_vertices = (int(max(uu.max(initial=-1), vv.max(initial=-1)) + 1)
                      if uu.size else 0)
    key = uu * np.int64(n_vertices) + vv
    _, uniq = np.unique(key, return_index=True)
    uu, vv = uu[uniq], vv[uniq]
    return build_csr(n_vertices, uu, vv, labels=labels, device=device)


# Quantiles of the degree-profile sketch (the JAX package's plan-transfer
# identity).
DEGREE_QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)


def degree_profile(g: CSRGraph) -> tuple[float, ...]:
    """Quantiles of the degree vector at ``DEGREE_QUANTILES``."""
    if g.n_vertices == 0:
        return (0.0,) * len(DEGREE_QUANTILES)
    deg = g.degrees().cpu().numpy().astype(np.float64)
    return tuple(float(x) for x in np.quantile(deg, DEGREE_QUANTILES))


def neighbors_np(g: CSRGraph, v: int) -> np.ndarray:
    """The sorted neighbours of vertex ``v`` as a numpy array."""
    rp = g.row_ptr.cpu().numpy()
    return g.col_idx.cpu().numpy()[rp[v]:rp[v + 1]]


def to_networkx(g: CSRGraph):
    """The graph as an undirected networkx graph, labels as the node
    attribute ``label`` (for oracle checks in tests)."""
    import networkx as nx

    G = nx.Graph()
    G.add_nodes_from(range(g.n_vertices))
    src, dst = (t.cpu().numpy() for t in g.edge_list())
    for s, d in zip(src, dst):
        if s < d:
            G.add_edge(int(s), int(d))
    if g.labels is not None:
        for v, lab in enumerate(g.labels.cpu().numpy()):
            G.nodes[v]["label"] = int(lab)
    return G
