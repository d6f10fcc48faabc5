"""Pattern codes (paper §3.2; counterpart of ``repro.core.pattern``).

An embedding's subgraph is packed into an int32 code: vertex labels in the
high digits (label-major), upper-triangle adjacency bits in the low bits,
so minimising the code over vertex permutations is a lexicographic
(labels, adjacency) minimisation.  The arithmetic is int32 and wraps as
JAX's does, because FSM's codes are an output both packages must agree on.
This slice ports the packing the FSM reduce uses; the motif classifiers
wait for the reduce of vertex apps.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


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
