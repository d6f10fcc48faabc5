"""SoA embedding lists (paper §5.1, Fig. 8; counterpart of
``repro.core.embedding_list``).

Level ``L_i`` stores columnar int32 tensors ``vid`` (the (i+1)-th vertex of
each embedding) and ``idx`` (parent index in ``L_{i-1}``), allocated at a
static capacity with a valid count ``n`` held as a 0-d device tensor, so a
level can be produced without reading the device.  Edge-induced levels
also store ``his`` (the vertex slot the new edge grew from) and ``eid``
(its undirected edge id).  A vertex level of an app with a kernel state
update also stores ``state``, the i32 memo state the extend compacted with
the level (the pattern-set trie's branch bitmap).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class EmbeddingLevel:
    """One level of the prefix tree (static capacity, 0-d valid count)."""

    vid: torch.Tensor                     # int32[cap]
    idx: torch.Tensor                     # int32[cap] parent pointer
    n: torch.Tensor                       # int32[] valid prefix length
    his: Optional[torch.Tensor] = None    # int32[cap] source slot (edge)
    eid: Optional[torch.Tensor] = None    # int32[cap] edge uid (edge)
    state: Optional[torch.Tensor] = None  # int32[cap] kernel memo state

    @property
    def capacity(self) -> int:
        return self.vid.shape[0]

    def nbytes(self) -> int:
        cols = [c for c in (self.vid, self.idx, self.his, self.eid,
                            self.state) if c is not None]
        return sum(c.numel() for c in cols) * 4 + 4


def init_level0_vertex(src: torch.Tensor, dst: torch.Tensor,
                       n: torch.Tensor | int) -> list[EmbeddingLevel]:
    """Initial worklist of single-edge embeddings (Alg. 1 line 4): level 0
    stores v0 in ``idx`` and v1 in ``vid``."""
    n = torch.as_tensor(n, dtype=torch.int32, device=src.device)
    return [EmbeddingLevel(vid=dst.to(torch.int32), idx=src.to(torch.int32),
                           n=n)]


def init_level0_edge(src: torch.Tensor, dst: torch.Tensor,
                     eid: torch.Tensor, n: torch.Tensor | int
                     ) -> list[EmbeddingLevel]:
    """Initial worklist of the edge-induced pipeline: one edge each."""
    n = torch.as_tensor(n, dtype=torch.int32, device=src.device)
    return [EmbeddingLevel(vid=dst.to(torch.int32), idx=src.to(torch.int32),
                           n=n, his=torch.zeros_like(dst, dtype=torch.int32),
                           eid=eid.to(torch.int32))]


def materialize(levels: list[EmbeddingLevel]) -> torch.Tensor:
    """Backtrack the prefix tree into an int32 [cap_last, k] vertex matrix
    (k = len(levels) + 1), columns in extension order.  Rows past the last
    level's valid count are garbage for the caller to mask."""
    last = levels[-1]
    cols = [last.vid]
    ptr = last.idx
    for lvl in reversed(levels[:-1]):
        p = ptr.long()
        cols.append(lvl.vid[p])
        ptr = lvl.idx[p]
    cols.append(ptr)
    return torch.stack(cols[::-1], dim=1)


def materialize_edges(levels: list[EmbeddingLevel]):
    """Edge-induced backtracking: ``(v0 int32[cap], vid, his, eid)``, the
    last three int32[cap, E] with E = len(levels); column j holds edge
    j's destination vertex, source slot and undirected edge id, and v0 is
    edge 0's source vertex."""
    last = levels[-1]
    vids, hiss, eids = [last.vid], [last.his], [last.eid]
    ptr = last.idx
    for lvl in reversed(levels[:-1]):
        p = ptr.long()
        vids.append(lvl.vid[p])
        hiss.append(lvl.his[p])
        eids.append(lvl.eid[p])
        ptr = lvl.idx[p]
    return (ptr, torch.stack(vids[::-1], dim=1),
            torch.stack(hiss[::-1], dim=1), torch.stack(eids[::-1], dim=1))


def total_bytes(levels: list[EmbeddingLevel]) -> int:
    return sum(lvl.nbytes() for lvl in levels)
