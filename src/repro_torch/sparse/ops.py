"""Sparse and ragged primitives (counterpart of ``repro.sparse.ops``):
static output sizes, no host sync.

Two consumers share them: the mining engine (``expand_ragged`` and
``compact_mask``, inspection-execution's ragged expansion and stream
compaction, paper §5.3) and GNN message passing (``segment_sum``,
``segment_max``, ``segment_mean``, ``edge_softmax``; ``embedding_bag``
for recsys tables).

``segment_sum`` is where the JAX package calls ``jax.ops.segment_sum``,
and it runs on the segment-sum kernel (``kernels/segsum``): its forward is
``sorted_segment_sum`` on the data as ``[N, -1]`` rows (a CUDA tensor
launches the kernel, a CPU tensor runs its plain version), its backward a
gather of the output gradient by id, zero for an id out of range.  The
gather is an autograd function of its own whose backward is
``segment_sum`` again, so a gradient of a gradient (NequIP's and
EquiformerV2's forces, ``-dE/dpos``, inside their losses) sums on the
kernel too.  On the card the kernel adds with atomics, so f32 sums agree
with the CPU's to rounding, not bit for bit.  ``segment_max`` is a
PyTorch ``scatter_reduce``, as JAX's runs outside any Pallas kernel: an
empty segment holds ``-inf``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segsum import ops as segsum_ops


def _ids(segment_ids: torch.Tensor) -> torch.Tensor:
    """The ids as the kernel takes them: contiguous int32."""
    return segment_ids.to(torch.int32).contiguous()


def _segsum(data: torch.Tensor, ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    rows = data.reshape(data.shape[0], -1).contiguous()
    out = segsum_ops.sorted_segment_sum(rows, ids, num_segments)
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


def _gather(g: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``g[ids]``, zero rows where an id lies outside ``[0, len(g))``."""
    n = g.shape[0]
    keep = (ids >= 0) & (ids < n)
    if n == 0:
        return g.new_zeros((ids.shape[0],) + tuple(g.shape[1:]))
    rows = g.index_select(0, torch.where(keep, ids, 0))
    return torch.where(keep.reshape((-1,) + (1,) * (g.dim() - 1)), rows, 0)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        return _segsum(data, ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _Gather.apply(g, ids), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, ids):
        ctx.save_for_backward(ids)
        ctx.num_segments = g.shape[0]
        return _gather(g, ids)

    @staticmethod
    def backward(ctx, gg):
        (ids,) = ctx.saved_tensors
        return _SegmentSum.apply(gg, ids, ctx.num_segments), None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[i] over the i with segment_ids[i] == s``,
    ``[num_segments, *data.shape[1:]]``; ids outside ``[0,
    num_segments)`` add nothing.  f32 or bf16 data."""
    return _SegmentSum.apply(data, _ids(segment_ids), num_segments)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The largest row of each segment; ``-inf`` where a segment is empty,
    and ids out of range dropped, as ``jax.ops.segment_max``."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    idx = torch.where(keep, ids, num_segments)     # a spare row, cut off
    idx = idx.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    return out.scatter_reduce(0, idx, data, "amax")[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The segment sums over the segments' row counts (at least 1)."""
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                      num_segments)
    return tot / torch.clamp_min(cnt, 1.0).reshape(
        (-1,) + (1,) * (tot.dim() - 1))


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    """Softmax over each destination node's incoming edges (GAT).

    scores: f[E, ...heads]; dst: int[E].  Returns normalized scores.
    """
    dst = dst.long()
    smax = segment_max(scores, dst, num_nodes)
    # gather the max back to the edges; subtract it for stability
    ex = torch.exp(scores - smax[dst])
    denom = segment_sum(ex, dst, num_nodes)
    return ex / torch.clamp_min(denom[dst], 1e-30)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int, mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """EmbeddingBag from a gather and a segment op.

    table: f[V, D]; indices: int[N] (flattened multi-hot ids); bag_ids:
    int[N] mapping each index to its bag; returns f[num_bags, D].
    """
    rows = table[indices.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_sum(rows, bag_ids, num_bags)
    if mode == "mean":
        return segment_mean(rows, bag_ids, num_bags)
    if mode == "max":
        return segment_max(rows, bag_ids, num_bags)
    raise ValueError(mode)


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
