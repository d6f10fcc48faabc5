"""Plain PyTorch version of the segment-sum kernel (counterpart of
``repro.kernels.segsum.ref.sorted_segment_sum_ref``).

It computes what ``csrc/segsum.cu`` computes, with PyTorch ops, on any
device: an ``index_add_`` in f32 that drops ids outside ``[0,
n_segments)``, as ``jax.ops.segment_sum`` does, cast to the data's dtype.
The wrapper in ``ops.py`` takes it for CPU tensors; the tests hold it
against the JAX package's Pallas kernel in interpret mode and its
``segment_sum`` oracle, and ``chip_smoke.py`` holds the kernel against it
on the card.  ``calls`` counts how often it ran.
"""
from __future__ import annotations

import torch


def sorted_segment_sum_ref(data, seg_ids, n_segments: int):
    """out[s] = sum of data[i] over the rows with seg_ids[i] == s, [S, D] in
    data's dtype.  The ids need not be sorted."""
    sorted_segment_sum_ref.calls += 1
    d = data.shape[1]
    # an out-of-range id adds into a spare row that is cut off, so the
    # rows of data are never copied
    keep = (seg_ids >= 0) & (seg_ids < n_segments)
    idx = torch.where(keep, seg_ids, n_segments)
    out = torch.zeros(n_segments + 1, d, dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, idx, data.float())
    return out[:n_segments].to(data.dtype)


sorted_segment_sum_ref.calls = 0
