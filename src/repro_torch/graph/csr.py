"""Compressed-sparse-row graph storage on torch tensors (counterpart of
``repro.graph.csr``).

Neighbour lists are sorted ascending, as the paper keeps them (§6.1), which
is what makes the binary-search connectivity check possible.  Building the
CSR is host-side numpy preprocessing; the result lives on one device as
int32 tensors.  The bit-packed adjacency (``PackedGraph``) is ported for
the *full* pack only: the partial and core packs wait for a later slice.
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

    ``words[r, w]`` holds bits ``32*w .. 32*w+31`` of vertex r's row as an
    int32 bit pattern (the JAX package stores u32; torch's uint32 lacks
    shift and bitwise kernels on the CPU, and ``(w >> b) & 1`` reads bit 31
    correctly from the int32 pattern).  Only the full pack is ported, so
    ``row_slot`` is the identity, ``full`` is True and ``n_cols`` is
    ``n_vertices``; the fields keep the JAX layout for the later slice that
    ports partial and core packs.
    """

    words: torch.Tensor        # int32[n_packed, n_words]
    row_slot: torch.Tensor     # int32[n_vertices]
    n_words: int
    full: bool
    n_cols: int

    @property
    def n_packed(self) -> int:
        return int(self.words.shape[0])


def pack_adjacency(g: CSRGraph, max_bytes: int = 4 << 20
                   ) -> Optional[PackedGraph]:
    """The full bit-packed adjacency of ``g``, built on the host.

    Returns None for an empty graph.  When the full pack does not fit
    ``max_bytes`` the JAX package builds a partial or core pack; those are
    not ported yet, so this raises instead of returning something else.
    """
    n = g.n_vertices
    if n == 0:
        return None
    n_words = -(-n // 32)
    if n * n_words * 4 > max_bytes:
        raise NotImplementedError(
            f"the full pack needs {n * n_words * 4} bytes > max_bytes="
            f"{max_bytes}; partial and core packs are not ported yet")
    rp = g.row_ptr.cpu().numpy().astype(np.int64)
    ci = g.col_idx.cpu().numpy().astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), rp[1:] - rp[:-1])
    words = np.zeros(n * n_words, dtype=np.uint32)
    np.bitwise_or.at(words, src * n_words + (ci >> 5),
                     np.uint32(1) << (ci & 31).astype(np.uint32))
    words = words.view(np.int32).reshape(n, n_words)
    dev = g.device
    return PackedGraph(words=torch.from_numpy(words.copy()).to(dev),
                       row_slot=torch.arange(n, dtype=torch.int32,
                                             device=dev),
                       n_words=int(n_words), full=True, n_cols=int(n))


def packed_contains(pg: PackedGraph, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Bitmap membership: is v in N(u)?  Out-of-range u or v -> False."""
    n_vertices = pg.row_slot.shape[0]
    slot = pg.row_slot[u.clamp(0, n_vertices - 1).long()]
    v_c = v.clamp(0, pg.n_cols - 1)
    word = pg.words[slot.clamp(0, pg.words.shape[0] - 1).long(),
                    (v_c >> 5).long()]
    bit = (word >> (v_c & 31)) & 1
    return ((bit == 1) & (slot >= 0) & (u >= 0) & (v >= 0)
            & (u < n_vertices) & (v < pg.n_cols))


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
                   device: DeviceSpec = None) -> CSRGraph:
    """Symmetric, loop-free, deduplicated CSR graph from (u, v) pairs."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    u, v = edges[:, 0], edges[:, 1]
    keep = u != v
    u, v = u[keep], v[keep]
    uu = np.concatenate([u, v])
    vv = np.concatenate([v, u])
    if n_vertices is None:
        n_vertices = (int(max(uu.max(initial=-1), vv.max(initial=-1)) + 1)
                      if uu.size else 0)
    key = uu * np.int64(n_vertices) + vv
    _, uniq = np.unique(key, return_index=True)
    uu, vv = uu[uniq], vv[uniq]
    return build_csr(n_vertices, uu, vv, labels=labels, device=device)
