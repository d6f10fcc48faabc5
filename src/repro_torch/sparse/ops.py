"""Ragged primitives of inspection-execution (counterpart of
``repro.sparse.ops``): static output sizes, no host sync."""
from __future__ import annotations

import torch


def expand_ragged(counts: torch.Tensor, capacity: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-parent counts -> (parent, rank) of each output slot (§5.3).

    Returns (parent int32[capacity], rank int32[capacity], total int32[]).
    Slots >= total hold parent == -1 and rank == 0.
    """
    dev = counts.device
    counts = counts.to(torch.int32)
    n = counts.shape[0]
    offsets = torch.cumsum(counts, 0, dtype=torch.int32)   # inclusive
    total = offsets[-1] if n else torch.zeros((), dtype=torch.int32,
                                              device=dev)
    starts = offsets - counts if n else torch.zeros(1, dtype=torch.int32,
                                                    device=dev)
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    if n:
        parent = torch.searchsorted(offsets, slots, right=True,
                                    out_int32=True)
    else:
        parent = torch.zeros(capacity, dtype=torch.int32, device=dev)
    valid = slots < total
    parent = torch.where(valid, parent, -1)
    # torch raises on an out-of-range gather where XLA clamps: clip first
    p_c = parent.clamp(0, starts.shape[0] - 1).long()
    rank = torch.where(valid, slots - starts[p_c], 0)
    return parent, rank.to(torch.int32), total.to(torch.int32)


def compact_mask(mask: torch.Tensor, capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable stream compaction by prefix sum.

    Returns (gather_idx int32[capacity], n_valid int32[]): ``x[gather_idx]``
    packs the masked elements of x to the front; slots >= n_valid hold 0.
    """
    dev = mask.device
    mi = mask.to(torch.int32)
    pos = torch.cumsum(mi, 0, dtype=torch.int32) - mi     # exclusive
    n_valid = mi.sum(dtype=torch.int32)
    src = torch.arange(mask.shape[0], dtype=torch.int32, device=dev)
    # one spare slot takes every dropped write (JAX's mode="drop")
    out = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    dest = torch.where(mask, pos.clamp(max=capacity), capacity).long()
    out.index_put_((dest,), src)
    return out[:capacity], n_valid
